"""Diagonal empirical-Fisher preconditioner for CG (port of
:mod:`pytorchhessianfree_tpu.ops.precond`).

The diagonal of the empirical Fisher is ``sum_i g_i^2`` over the gradients
``g_i`` of the per-sample losses, divided by ``N`` for
``reduction="mean"``.  :func:`diag_EF` takes all per-sample gradients in
one batched pass, ``torch.func.vmap(torch.func.grad(...))``, and holds them
as an ``[N, dim]`` matrix; :func:`diag_EF_scan` loops over the samples in
Python with O(dim) memory, as the reference's autograd loop does.

Each sample goes through the *batched* model as a batch of one, as in the
JAX package: a model with batch statistics (ResNet-18's BatchNorm)
normalizes over that one sample's positions.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.func import grad, vmap

from ..utils.flatten import (
    TrainableRavel,
    tree_flatten,
    tree_map,
    tree_unflatten,
)


def _one_sample_loss(model_fn, loss_outer):
    """Loss of one sample, fed to the batched model with a singleton batch
    axis (with ``N = 1`` the "mean" and "sum" reductions coincide).  Inputs
    and targets may be trees; every leaf gets the axis."""

    def loss(params, x, y):
        add_batch = lambda t: tree_map(lambda a: a[None], t)  # noqa: E731
        return loss_outer(model_fn(params, add_batch(x)), add_batch(y))

    return loss


def _check_reduction(reduction: str):
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction {reduction} is not supported.")


def _reg_grad(loss_reg, params, ravel: TrainableRavel):
    return None if loss_reg is None else ravel.ravel(grad(loss_reg)(params))


def _num_samples(inputs) -> int:
    return tree_flatten(inputs)[0][0].shape[0]


def _sample_grads(model_fn, loss_outer, params, inputs, targets):
    """Every sample's gradient tree, leaves ``[N, ...]``, from one batched
    pass."""
    return vmap(
        grad(_one_sample_loss(model_fn, loss_outer)), in_dims=(None, 0, 0)
    )(params, inputs, targets)


def _pairwise_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``'s sum over dimension 0, adjacent rows added pairwise level by
    level: one order for every entry, whatever the leaf's other dimensions
    (``torch.sum`` orders a width's last few columns otherwise), so that a
    leaf and a block of it sum each entry alike."""
    while t.shape[0] > 1:
        pairs = t[0:t.shape[0] // 2 * 2:2] + t[1::2]
        t = torch.cat([pairs, t[-1:]]) if t.shape[0] % 2 else pairs
    return t[0]


def diag_EF(
    model_fn: Callable[[Any, Any], Any],
    loss_outer: Callable[[Any, Any], torch.Tensor],
    params: Any,
    inputs: Any,
    targets: Any,
    reduction: str,
    ravel: TrainableRavel,
    loss_reg: Optional[Callable[[Any], torch.Tensor]] = None,
) -> torch.Tensor:
    """Diagonal of the empirical Fisher from one batched pass.

    The per-sample gradient tree comes out of ``vmap`` with ``[N, ...]``
    leaves; each leaf's squares are summed over the samples pairwise
    (:func:`_pairwise_sum`), and the tree of sums is raveled once.  With
    ``loss_reg``, its one gradient is added to every sample's before
    squaring (the reference's ``diag_EF_autograd``, the variant documented
    for L2-regularized losses).

    ``ravel`` may be a sharded step's local layout
    (:class:`~..parallel.layout.LocalLayout`): a leaf that the forward
    splits is then this rank's block, whose per-sample gradients are the
    rank's block of the whole program's, so their squares sum alike and
    are laid out to the rank's flat block."""
    _check_reduction(reduction)
    leaves, treedef = tree_flatten(
        _sample_grads(model_fn, loss_outer, params, inputs, targets))
    leaves = [g.to(ravel.dtype) for g in leaves]
    if loss_reg is not None:
        reg = tree_flatten(grad(loss_reg)(params))[0]
        leaves = [g + r.to(ravel.dtype) for g, r in zip(leaves, reg)]
    diag = ravel.ravel(tree_unflatten(
        treedef, [_pairwise_sum(g**2) for g in leaves]))
    if reduction == "mean":
        diag = diag / _num_samples(inputs)
    return diag


def diag_EF_scan(
    model_fn: Callable[[Any, Any], Any],
    loss_outer: Callable[[Any, Any], torch.Tensor],
    params: Any,
    inputs: Any,
    targets: Any,
    reduction: str,
    ravel: TrainableRavel,
    loss_reg: Optional[Callable[[Any], torch.Tensor]] = None,
) -> torch.Tensor:
    """Diagonal of the empirical Fisher, one sample at a time: O(dim)
    memory in place of :func:`diag_EF`'s ``[N, dim]``."""
    _check_reduction(reduction)
    one_grad = grad(_one_sample_loss(model_fn, loss_outer))
    reg = _reg_grad(loss_reg, params, ravel)
    diag = ravel.zeros()
    for i in range(_num_samples(inputs)):
        take = lambda t: tree_map(lambda a: a[i], t)  # noqa: E731
        g = ravel.ravel(one_grad(params, take(inputs), take(targets)))
        if reg is not None:
            g = g + reg
        diag = diag + g**2
    if reduction == "mean":
        diag = diag / _num_samples(inputs)
    return diag


def diag_to_preconditioner(
    diag_vec: torch.Tensor, damping, exponent: float = 0.75
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Martens' ``(D + damping I)^(-exponent)`` preconditioner matvec.  The
    scale vector is formed once here, not on every CG iteration."""
    scale = (diag_vec + damping) ** (-exponent)

    def M_func(x):
        return scale * x

    return M_func


class EMADiag:
    """Exponential moving average of per-batch preconditioner diagonals,
    kept on the host side of the loop::

        ema = EMADiag(decay=0.9)
        for batch in batches:
            diag = opt.get_preconditioner(*batch, reduction="mean")
            opt.step(batch, precond_diag=ema.update(diag))
    """

    def __init__(self, decay: float = 0.9):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"Invalid decay {decay}")
        self.decay = decay
        self.diag: Optional[torch.Tensor] = None

    def update(self, diag: torch.Tensor) -> torch.Tensor:
        if self.diag is None:
            self.diag = diag
        else:
            self.diag = self.decay * self.diag + (1.0 - self.decay) * diag
        return self.diag


def diag_EF_preconditioner(
    model_fn: Callable[[Any, Any], Any],
    loss_outer: Callable[[Any, Any], torch.Tensor],
    params: Any,
    inputs: Any,
    targets: Any,
    reduction: str,
    damping,
    exponent: Optional[float] = None,
    ravel: Optional[TrainableRavel] = None,
    use_scan: bool = False,
    loss_reg: Optional[Callable[[Any], torch.Tensor]] = None,
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], torch.Tensor]:
    """The empirical-Fisher diagonal and its preconditioner closure:
    returns ``(M_func, diag)`` (the reference's wrapper returns ``None``;
    the JAX package and this port return both)."""
    if ravel is None:
        ravel = TrainableRavel(params)
    fn = diag_EF_scan if use_scan else diag_EF
    diag = fn(
        model_fn, loss_outer, params, inputs, targets, reduction, ravel,
        loss_reg=loss_reg,
    )
    exponent = 0.75 if exponent is None else exponent
    return diag_to_preconditioner(diag, damping, exponent), diag
