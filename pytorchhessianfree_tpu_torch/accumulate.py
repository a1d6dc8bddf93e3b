"""Chunked accumulation of loss, gradient and curvature matvecs (port of
:mod:`pytorchhessianfree_tpu.accumulate`).

The reference's ``acc_step`` evaluates the loss, the gradient and the
curvature matvec each over its own list of mini-batches and accumulates
``result += N_i * r_i``, then divides by the sample count for
``reduction="mean"``; for ``"sum"`` it adds plain sums.  Batches far larger
than one pass fit then go through the optimizer.

Two layouts of a datalist:

- **stacked**: ``(inputs, targets)`` with a leading chunk axis
  ``[C, N, ...]``, or :class:`StackedData` to say so unambiguously; every
  chunk weighs ``N`` and the mean divides by ``C * N``;
- **list**: a Python list of ``(inputs, targets)`` chunks of any sizes
  (ragged), each weighted by its own ``N``.

A parameter-only regularizer (``fns.loss_reg``) is added once, after the
accumulation.

The default matvec re-derives each chunk's curvature product on every call,
as the reference does, with the one-shot ``ggnvp`` / ``hvp`` of
:mod:`.ops.curvature` (a jvp and a vjp per chunk, no trace).  Only
``amortize=True`` (GGN, stacked data) linearizes, once per step.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple, Union

import torch
from torch.func import grad, jvp

from .config import HFConfig
from .ops.curvature import ggnvp, ggnvp_fn, hvp, value_and_grad
from .utils.flatten import (
    TrainableRavel,
    tree_flatten,
    tree_map,
    tree_unflatten,
)

Datalist = Union[Tuple[Any, Any], Sequence[Tuple[Any, Any]]]


class StackedData(NamedTuple):
    """A stacked datalist, marked as such: ``inputs`` and ``targets`` are
    trees whose leaves are ``[C, N, ...]``.

    A plain ``(inputs, targets)`` 2-tuple whose first element is a tensor
    is taken as stacked too, as in the JAX package; a single batch passed
    where a datalist is expected would then be re-chunked along its batch
    axis.  Pass ``StackedData(xs, ys)``, or a one-element list ``[(x, y)]``
    for a single chunk, to be unambiguous.
    """

    inputs: Any
    targets: Any


def _is_stacked(data: Datalist) -> bool:
    if isinstance(data, StackedData):
        return True
    return (
        isinstance(data, tuple)
        and len(data) == 2
        and hasattr(data[0], "ndim")
    )


def _first_leaf(t):
    return tree_flatten(t)[0][0]


def _chunks(data: Datalist) -> List[Tuple[Any, Any]]:
    if _is_stacked(data):
        xs, ys = data
        return [
            (tree_map(lambda a: a[i], xs), tree_map(lambda a: a[i], ys))
            for i in range(_first_leaf(xs).shape[0])
        ]
    return list(data)


def _tree_combine(fn, *trees):
    leaves = [tree_flatten(t)[0] for t in trees]
    treedef = tree_flatten(trees[0])[1]
    return tree_unflatten(treedef, [fn(*ls) for ls in zip(*leaves)])


def _check_reduction(reduction: str):
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Invalid reduction {reduction}")


def acc_reduce(
    data: Datalist,
    eval_chunk: Callable[[Any, Any], Any],
    reduction: str,
) -> Any:
    """Accumulate ``eval_chunk(inputs, targets)`` (a tensor or a tree of
    them) over the chunks: add ``N * result`` ("mean") or ``result``
    ("sum") per chunk of ``N`` samples, then divide by the sample count for
    the mean.  Stacked chunks all weigh the same ``N``, so their mean
    divides by ``C * N``."""
    _check_reduction(reduction)
    total, num_data = None, 0
    for x, y in _chunks(data):
        n = int(_first_leaf(y).shape[0])
        num_data += n
        w = n if reduction == "mean" else 1
        r = _tree_combine(lambda b: w * b, eval_chunk(x, y))
        total = r if total is None else _tree_combine(torch.add, total, r)
    if reduction == "mean":
        total = _tree_combine(lambda a: a / num_data, total)
    return total


def acc_loss(fns, params, data: Datalist, reduction: str) -> torch.Tensor:
    """Accumulated loss; ``fns.loss_reg`` is added once, after the chunks
    (weighting it per chunk would scale it by the chunk count under
    "sum")."""
    loss = acc_reduce(
        data, lambda x, y: fns.data_loss(params, (x, y)), reduction
    )
    if fns.loss_reg is not None:
        loss = loss + fns.loss_reg(params)
    return loss


def _reduced_ravel(ravel: TrainableRavel, reduce=None):
    """The data term's tree -> its flat vector: ``ravel.ravel``, or with a
    step's ``reduce`` (the data-parallel and sharded steps'), combined
    across their ranks by ``reduce.ravel``."""
    if reduce is None:
        return ravel.ravel
    return lambda tree: reduce.ravel(tree, ravel)


def acc_grad(
    fns, params, data: Datalist, reduction: str, ravel: TrainableRavel
) -> torch.Tensor:
    """Accumulated flat gradient; the regularizer's gradient is added once,
    after the chunks.  The chunks' gradient trees are summed and raveled
    once."""
    return _acc_grad(fns, params, data, reduction, ravel)


def _acc_grad(fns, params, data, reduction, ravel, reduce=None):
    """:func:`acc_grad`, the data term raveled by :func:`_reduced_ravel`."""

    def chunk_grad(x, y):
        return value_and_grad(lambda p: fns.data_loss(p, (x, y)), params)[1]

    out = _reduced_ravel(ravel, reduce)(acc_reduce(data, chunk_grad,
                                                  reduction))
    if fns.loss_reg is not None:
        out = out + ravel.ravel(grad(fns.loss_reg)(params))
    return out


def make_acc_mvp(
    fns,
    config: HFConfig,
    params,
    data: Datalist,
    reduction: str,
    ravel: TrainableRavel,
    amortize: bool = False,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Accumulated (undamped) curvature matvec on flat vectors.

    ``amortize=False``: each call forms every chunk's product anew with the
    one-shot ``ggnvp`` / ``hvp`` (O(chunk) memory).  ``amortize=True`` (GGN
    and stacked data only; otherwise ignored): linearize the model over all
    chunks once and replay the linearization on every call, which holds
    every chunk's tangent graph at once.
    """
    return _make_acc_mvp(fns, config, params, data, reduction, ravel,
                         amortize)


def _make_acc_mvp(fns, config, params, data, reduction, ravel, amortize,
                  reduce=None):
    """:func:`make_acc_mvp`, the data term's products raveled by
    :func:`_reduced_ravel`."""
    _check_reduction(reduction)
    flat = _reduced_ravel(ravel, reduce)
    if amortize and config.curvature_opt == "ggn" and _is_stacked(data):
        chunks = _chunks(data)
        w = 1.0 / len(chunks) if reduction == "mean" else 1.0

        def total_model(p):
            return [fns.model_fn(p, x) for x, _ in chunks]

        def total_outer(outs):
            return w * sum(
                fns.loss_outer(o, y) for o, (_, y) in zip(outs, chunks)
            )

        _, _, _, gv = ggnvp_fn(total_model, total_outer, params)

        def mvp_amortized(v: torch.Tensor) -> torch.Tensor:
            return flat(gv(ravel.unravel(v)))

        return mvp_amortized

    def mvp(v: torch.Tensor) -> torch.Tensor:
        tangent = ravel.unravel(v)

        def chunk_mvp(x, y):
            if config.curvature_opt == "ggn":
                return ggnvp(
                    lambda p: fns.model_fn(p, x),
                    lambda o: fns.loss_outer(o, y),
                    params,
                    tangent,
                )
            return hvp(lambda p: fns.data_loss(p, (x, y)), params, tangent)

        out = flat(acc_reduce(data, chunk_mvp, reduction))
        if config.curvature_opt == "hessian" and fns.loss_reg is not None:
            # the Hessian of the objective holds the regularizer's once; the
            # GGN, defined through the outputs, holds none of it
            reg_hv = jvp(grad(fns.loss_reg), (params,), (tangent,))[1]
            out = out + ravel.ravel(reg_hv)
        return out

    return mvp


def pad_ragged_datalist(datalist):
    """Pad a ragged datalist to uniform chunks plus per-sample weights.

    Every chunk is padded to the largest size by repeating its last row;
    the weights are 1 for real samples and 0 for padding.  Returns
    ``(xs [C, Nmax, ...], ys [C, Nmax, ...], w [C, Nmax], total)`` with
    ``total`` the real sample count; use it with :func:`weighted_fns`.
    """
    chunks = list(datalist)
    n_max = max(int(y.shape[0]) for _, y in chunks)
    xs, ys, ws = [], [], []
    total = 0
    for x, y in chunks:
        n = int(y.shape[0])
        total += n
        pad = n_max - n
        if pad:
            x = torch.cat([x, x[-1:].repeat_interleave(pad, dim=0)])
            y = torch.cat([y, y[-1:].repeat_interleave(pad, dim=0)])
        xs.append(x)
        ys.append(y)
        ws.append(torch.cat([
            torch.ones(n, dtype=x.dtype, device=x.device),
            torch.zeros(pad, dtype=x.dtype, device=x.device),
        ]))
    return torch.stack(xs), torch.stack(ys), torch.stack(ws), total


def weighted_fns(model_fn, per_sample_loss, total, reduction: str = "mean"):
    """Model fns over weight-augmented batches for padded ragged datalists.

    ``per_sample_loss(outputs, targets) -> [N]``.  The batch is
    ``(inputs, (targets, weights))`` and the loss is the weighted sum,
    divided by ``total`` for "mean".  Accumulating the padded stacked
    datalist with ``reduction="sum"`` then gives the ragged list's exact
    mean or sum::

        hf_acc_step(..., loss_data=(xs, (ys, w)), reduction="sum")
    """
    from .optimizer import HFModelFns

    _check_reduction(reduction)
    denom = float(total) if reduction == "mean" else 1.0

    def loss_outer(outputs, targets_and_w):
        targets, w = targets_and_w
        return torch.sum(per_sample_loss(outputs, targets) * w) / denom

    return HFModelFns(model_fn=model_fn, loss_outer=loss_outer)


def concat_datalist(data: Datalist) -> Tuple[Any, Any]:
    """Concatenate a datalist into one batch (the reduction self-test's
    reference).  Inputs and targets may be trees; each leaf is concatenated
    along its leading axis."""
    chunks = _chunks(data)
    cat = lambda *leaves: torch.cat(leaves, dim=0)  # noqa: E731
    xs = _tree_combine(cat, *[x for x, _ in chunks])
    ys = _tree_combine(cat, *[y for _, y in chunks])
    return xs, ys
