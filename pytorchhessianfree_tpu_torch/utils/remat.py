"""Rematerialization that composes with ``torch.func`` (the counterpart of
``jax.checkpoint``).

``checkpoint(fn)`` returns a function with ``fn``'s values that saves only
its inputs for differentiation and runs ``fn`` again when a derivative is
needed: its backward recomputes under plain autograd (or, inside a
``torch.func`` transform, with ``torch.func.grad`` of ``<fn(x),
cotangent>``) and its forward-mode rule with ``torch.func.jvp`` of ``fn``.
Checkpoints nest (a rematerialized model whose blocks and attention chunks
are rematerialized too).  The activations inside ``fn`` are then never
held between the forward and the backward pass, in a gradient, a one-shot
GGN matvec (``ops.curvature.ggnvp``) or a one-shot Hessian-vector product
(``ops.curvature.hvp``, a ``torch.func.jvp`` of a gradient) alike.
Higher derivatives compose through ``torch.func`` transforms; plain
autograd's double backward (``create_graph=True`` outside any transform)
does not differentiate through a checkpoint's recomputation.

``torch.utils.checkpoint.checkpoint`` is not used: its saved-tensor hooks
fail under ``torch.func.vjp``.  A ``torch.autograd.Function`` with a
``jvp`` rule composes with ``torch.func.jvp``, ``vjp``, ``grad`` and
``vmap``, but not with ``torch.func.linearize``: linearize opens a plain
forward-mode level of its own (not a ``torch.func.jvp`` level), inside
which the rule's ``torch.func.jvp`` would open a second one.  Only there
does ``checkpoint`` call ``fn`` directly.  Nothing is lost by that: a
linearized tangent graph keeps every residual it needs as a constant, so it
stores the activations whatever the model does, and the values are the
same.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch._functorch import eager_transforms
from torch.autograd import forward_ad

from .flatten import tree_flatten, tree_unflatten


def _is_diff(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.is_floating_point()


class _Checkpoint(torch.autograd.Function):
    """``run(*tensors) -> tuple of tensors``, recomputed for derivatives."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *tensors):
        return run(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, *tensors = inputs
        ctx.run = run
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def backward(ctx, *cotangents):
        primals = ctx.saved_tensors
        if torch._C._functorch.peek_interpreter_stack() is None:
            # no transform is active (the backward of a torch.func.vjp
            # closure, or of plain autograd): recompute under plain
            # autograd, whose graph is freed as the backward goes, so that
            # nested checkpoints keep one segment's activations at a time
            # (this backward is not differentiated again: module docstring)
            with torch.enable_grad():
                xs = [p.detach().requires_grad_() for p in primals]
                grads = torch.autograd.grad(ctx.run(*xs), xs, cotangents,
                                            allow_unused=True)
            return (None, *(torch.zeros_like(x) if g is None else g
                            for x, g in zip(xs, grads)))

        def inner(*tensors):
            outs = ctx.run(*tensors)
            return sum(torch.sum(o * c) for o, c in zip(outs, cotangents))

        # inside a transform (the gradient under an HVP's jvp, vmap): the
        # vjp as the gradient of <run(x), cotangents>.  torch.func.grad
        # differentiates inside its own transform level, which a nested
        # checkpoint's backward needs (a torch.func.vjp closure would run
        # it after that level has closed)
        grads = torch.func.grad(inner, argnums=tuple(range(len(primals))))(
            *primals
        )
        return (None, *grads)

    @staticmethod
    def jvp(ctx, _run_tangent, *tangents):
        primals = ctx.saved_tensors
        tangents = tuple(
            torch.zeros_like(p) if t is None else t
            for p, t in zip(primals, tangents)
        )
        return torch.func.jvp(ctx.run, primals, tangents)[1]


def _under_linearize() -> bool:
    """A plain forward-mode level is open that no ``torch.func.jvp`` opened
    (``torch.func.linearize``'s trace): ``torch.func.jvp`` opens a level
    only when it is the outermost one."""
    return (forward_ad._current_level >= 0
            and eager_transforms.JVP_NESTING == 0)


def checkpoint(fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn(*args)`` with rematerialized derivatives.

    ``args`` and the result are trees of tensors (dicts, lists, tuples);
    floating-point leaves of ``args`` are differentiated, every other leaf
    (integer tokens, Python numbers) is held fixed.  The result's leaves
    must be floating-point tensors.
    """

    def wrapped(*args):
        if _under_linearize():  # module docstring
            return fn(*args)
        leaves, treedef = tree_flatten(args)
        where = [i for i, leaf in enumerate(leaves) if _is_diff(leaf)]
        out_def = []

        def run(*tensors):
            full = list(leaves)
            for i, t in zip(where, tensors):
                full[i] = t
            out_leaves, d = tree_flatten(fn(*tree_unflatten(treedef, full)))
            out_def[:] = [d]
            return tuple(out_leaves)

        out = _Checkpoint.apply(run, *(leaves[i] for i in where))
        return tree_unflatten(out_def[0], list(out))

    return wrapped
