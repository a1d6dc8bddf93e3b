"""Matrix-free curvature-vector products: HVP and GGN-VP (port of
:mod:`pytorchhessianfree_tpu.ops.curvature`).

The ``*_fn`` forms do the nonlinear work once per batch and return a matvec
closure that the CG loop calls once per iteration:

- ``ggnvp_fn``: ``torch.func.linearize`` of the model gives ``J v`` by
  replaying a traced tangent graph (the primal is not recomputed), and
  ``torch.func.vjp`` of the model gives ``J^T``.  Each matvec is then
  ``J v`` -> jvp of ``grad(loss_outer)`` at the outputs -> ``J^T``.
- ``hvp_fn``: ``torch.func.linearize`` of ``(grad, value)`` of the loss,
  forward over reverse.

``linearize`` traces the tangent graph with ``make_fx`` on the host, which
costs seconds per batch for a conv net (PERF.md, section 5).  Where a
product is needed once per batch and per CG iteration, as for each chunk of
an accumulated matvec, the one-shot forms ``ggnvp`` and ``hvp`` build and
apply the product in one call with ``torch.func.jvp`` and
``torch.func.vjp`` and trace nothing.

Gradients here come from :func:`value_and_grad`, a ``torch.func.vjp``
whose closure runs after its transform level has closed, not from
``torch.func.grad``: ``grad`` differentiates inside its level with
``create_graph=True``, so its backward records a graph that keeps
everything a checkpointed function (:mod:`~.utils.remat`) recomputes alive
until the gradient is complete, and rematerialization saves nothing.

Both work on parameter trees; the optimizer converts to and from the flat
CG vector space with :class:`~.utils.flatten.TrainableRavel`.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.func import grad, grad_and_value, jvp, linearize, vjp


def value_and_grad(
    fn: Callable[[Any], torch.Tensor], params: Any
) -> Tuple[torch.Tensor, Any]:
    """``(fn(params), gradient)`` of a scalar ``fn`` on trees, from one
    ``torch.func.vjp`` (module docstring)."""
    value, vjp_fn = vjp(fn, params)
    return value, vjp_fn(torch.ones_like(value))[0]


def hvp_fn(
    loss_fn: Callable[[Any], torch.Tensor], params: Any
) -> Tuple[torch.Tensor, Any, Callable[[Any], Any]]:
    """Hessian-vector product of ``loss_fn`` at ``params``.

    Returns ``(loss, grad, hvp)`` with ``hvp(v) = H @ v`` on trees.
    """
    (grad_tree, loss), tangent_fn = linearize(grad_and_value(loss_fn), params)

    def hvp(v: Any) -> Any:
        return tangent_fn(v)[0]

    return loss, grad_tree, hvp


def ggn_matvec_fn(
    model_fn: Callable[[Any], Any],
    loss_outer: Callable[[Any], torch.Tensor],
    params: Any,
) -> Tuple[Any, Callable[[Any], Any], Callable[[Any], Any]]:
    """The GGN-vector product ``Gv = J^T H_L (J v)`` alone, with no loss
    and no gradient.

    Returns ``(outputs, vjp_of_model, ggnvp)``: the model's outputs, its
    vjp closure and ``ggnvp(v)``, which maps a tangent tree to ``G @ v``.
    """
    outputs, vjp_of_model = vjp(model_fn, params)
    _, jvp_of_model = linearize(model_fn, params)
    loss_grad_fn = grad(loss_outer)

    def mvp(v: Any) -> Any:
        Jv = jvp_of_model(v)
        HJv = jvp(loss_grad_fn, (outputs,), (Jv,))[1]
        return vjp_of_model(HJv)[0]

    return outputs, vjp_of_model, mvp


def ggnvp_fn(
    model_fn: Callable[[Any], Any],
    loss_outer: Callable[[Any], torch.Tensor],
    params: Any,
) -> Tuple[torch.Tensor, Any, Any, Callable[[Any], Any]]:
    """GGN-vector product ``Gv = J^T H_L (J v)``, with the loss and the
    gradient of ``loss_outer(model_fn(params))`` from the same vjp.

    Returns ``(loss, outputs, grad, ggnvp)``.
    """
    outputs, vjp_of_model, mvp = ggn_matvec_fn(model_fn, loss_outer, params)
    loss = loss_outer(outputs)
    grad_tree = vjp_of_model(grad(loss_outer)(outputs))[0]
    return loss, outputs, grad_tree, mvp


def ggnvp(
    model_fn: Callable[[Any], Any],
    loss_outer: Callable[[Any], torch.Tensor],
    params: Any,
    v: Any,
) -> Any:
    """One GGN-vector product ``J^T H_L (J v)`` on trees, built and applied
    in one call: a jvp of the model (which also gives the outputs) and a vjp
    of it."""
    outputs, Jv = jvp(model_fn, (params,), (v,))
    HJv = jvp(grad(loss_outer), (outputs,), (Jv,))[1]
    return vjp(model_fn, params)[1](HJv)[0]


def hvp(loss_fn: Callable[[Any], torch.Tensor], params: Any, v: Any) -> Any:
    """One Hessian-vector product on trees, forward over reverse: the jvp
    of :func:`value_and_grad`'s gradient."""
    return jvp(lambda p: value_and_grad(loss_fn, p)[1], (params,), (v,))[1]
