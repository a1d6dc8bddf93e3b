"""Data-parallel Hessian-free steps over a process group (port of
:mod:`pytorchhessianfree_tpu.parallel.data_parallel`).

The reference reaches large batches only through sequential accumulation
(``acc_step``, reference optimizer.py:519-606).  Gradient, loss and
curvature-matvec accumulation are linear reductions, so here each rank of
the mesh's ``data`` axis holds its rows of the batch and a replica of the
parameters and the optimizer state, and computes

- its local loss, gradient and curvature matvec, and
- each loss of the backtracking walk and the line search,

after which one ``all_reduce`` over the axis turns each local value into
the global one: the mean of the ranks' means for ``reduction="mean"``
(equal shards), their sum for ``"sum"``.  CG, backtracking,
Levenberg-Marquardt damping, the line search and the update run replicated
on every rank (``optimizer._step_core``).

Three rules keep this correct:

- **The reductions run outside the transforms.**  Each is linear, so it
  runs on a transform's output: the matvec's flat output after the
  ``linearize`` replay, the summed squares after ``diag_EF``'s ``vmap``,
  and the vector of trial losses after a batched sweep's ``vmap`` (the
  ``sweep`` hook of :mod:`~..ops.select`).  The only collectives inside a
  transform are a forward's own (batch statistics, below), through
  :mod:`.collectives`.
- **The regularizer counts once.**  ``loss_reg`` depends only on the
  replicated parameters, so the ranks' data terms are reduced first and the
  regularizer is added after, as the JAX package combines only the data
  term.
- **The replicas stay bitwise identical.**  Every branch on the host reads a
  reduced value or one computed from replicated vectors, and the CG kernel
  uses no atomics, so every rank takes the same iterations; a rank that
  took another path would leave the others waiting in the next collective
  until the group's timeout.

Only ``all_reduce`` and ``broadcast`` are used: gloo, which lets several
ranks share one card, takes CUDA tensors for these two only.

A model whose forward couples the rows of a batch, such as ResNet-18's
BatchNorm with batch statistics or the MoE LM's routing, is where the two
families of builders differ, as they do in the JAX package:

- the GSPMD names (:func:`make_dp_hf_step`, :func:`make_dp_hf_train_loop`,
  :func:`make_dp_hf_acc_step`, and ``HessianFree(mesh=)`` over them) run
  the forward with the data axis as its batch axis
  (:func:`~.collectives.axes`): ``models.resnet.batchnorm`` takes the mean
  and the mean of squared deviations over every rank's rows with
  :func:`~.collectives.all_reduce_sum` inside the transforms, and
  ``models.moe`` routes every rank's rows together, so the step is the
  whole batch's step, as GSPMD's is.  Per-sample gradients
  (``dp_diag_EF``, the EMA diagonals) see each sample alone, as in the JAX
  package;
- the ``shard_map`` names (:func:`make_dp_hf_step_shardmap`,
  :func:`make_dp_hf_acc_step_shardmap`) set no batch axis: each rank
  normalizes its shard by the shard's statistics and routes its own
  rows, as JAX's ``shard_map`` step does, and the step is one process's accumulated step over the
  shards as chunks.

For a model whose rows do not couple, both families are one mechanism and
give the same numbers: ``optimizer``'s steps with a ``reduce`` over the
axis.  GSPMD derives the reduction from the
loss; the port cannot, so the GSPMD names take ``reduction="mean"`` as a
keyword (``HessianFree(mesh=)`` reads it from the loss,
:func:`_loss_reduction`).  Every step takes this rank's rows of the batch
(:func:`~.mesh.shard_batch`) and returns replicated results.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import accumulate as acc
from ..config import HFConfig
from . import collectives
from ..optimizer import (
    HFModelFns,
    _diag,
    _hf_acc_step,
    _hf_step,
    _train_loop,
    precond_arg,
)
from ..utils.flatten import TrainableRavel, tree_flatten, tree_map


class _Reduce:
    """The ranks' values of one evaluation -> the global value, over the
    group of one mesh axis: the sum, divided by the axis size for
    ``"mean"``.  The ``reduce`` of ``optimizer``'s steps."""

    def __init__(self, mesh, axis_name: str, reduction: str):
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Invalid reduction {reduction}")
        names = mesh.mesh_dim_names or ()
        if axis_name not in names:
            raise ValueError(f"mesh has no {axis_name!r} axis (axes {names})")
        self.group = mesh.get_group(axis_name)
        self.size = mesh.size(names.index(axis_name))
        self.reduction = reduction

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        # a copy: the input may be a view of something its owner still reads
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        out = self.sum(t)
        return out / self.size if self.reduction == "mean" else out

    def ravel(self, tree, ravel) -> torch.Tensor:
        """The data term's ``tree`` raveled by ``ravel``, then reduced."""
        return self(ravel.ravel(tree))

    def sample_squares(self, diag, fns, params, inputs, targets, ravel):
        """This rank's rows' sum of squared per-sample gradients through
        ``diag`` (``optimizer._diag``): a rank of the data axis holds each
        of its samples' whole gradient."""
        return diag(fns.model_fn, fns.loss_outer, params, inputs, targets,
                    "sum", ravel, loss_reg=fns.loss_reg)


def _broadcast_replicas(tree, mesh, axis_name: str = "data") -> None:
    """Overwrite every rank's tensors in ``tree`` with those of the axis's
    first rank, in place, so that the replicas start equal."""
    group = mesh.get_group(axis_name)
    src = dist.get_global_rank(group, 0)
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            buf = leaf.contiguous()
            dist.broadcast(buf, src=src, group=group)
            if buf is not leaf:
                leaf.copy_(buf)


def _loss_reduction(fns: HFModelFns, params, batch, mesh,
                    axis_name: str = "data") -> str:
    """The loss's reduction, ``"mean"`` or ``"sum"``, read from its data
    term on this rank's rows of ``batch`` and on their two halves, each
    summed over the ranks: ``HessianFree(mesh=)`` takes it from the loss,
    as the JAX package's GSPMD step does.  For a mean the whole equals the
    halves' row-weighted mean, for a sum their sum; every rank reads the
    same reduced values, so all decide alike.  Raises ``ValueError`` when
    the values fit neither (or a rank holds fewer than 2 rows)."""
    n = int(tree_flatten(batch)[0][0].shape[0])
    if n < 2:
        raise ValueError(
            "HessianFree(mesh=) reads the loss's reduction from each "
            f"rank's first batch and its halves; this rank has {n} row(s). "
            "Use make_dp_hf_step(reduction=...) to state it."
        )
    h = n // 2
    halves = [tree_map(lambda t: t[rows], batch)
              for rows in (slice(0, h), slice(h, n))]
    with torch.no_grad():
        whole = fns.data_loss(params, batch)
        a, b = (fns.data_loss(params, half) for half in halves)
        vals = _Reduce(mesh, axis_name, "sum")(torch.stack(
            [whole, (h * a + (n - h) * b) / n, a + b]).double())
    total, as_mean, as_sum = vals.tolist()
    err = {"mean": abs(total - as_mean), "sum": abs(total - as_sum)}
    best, other = sorted(err, key=err.get)
    if err[best] > 0.1 * err[other]:
        raise ValueError(
            f"The loss on each rank's rows ({total:.6g} over the ranks) is "
            f"neither the mean ({as_mean:.6g}) nor the sum ({as_sum:.6g}) "
            "of its values on their halves; HessianFree(mesh=) needs a "
            "\"mean\" or \"sum\" loss. Use make_dp_hf_step(reduction=...) "
            "to state it."
        )
    return best


def make_dp_hf_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
    precond_exponent: float = 0.75,
    donate: bool = False,
    reduction: str = "mean",
):
    """Data-parallel step: ``step(params, state, batch, precond_diag=None)
    -> (params, state, stats)`` with ``batch`` this rank's rows and the
    parameters, state and ``precond_diag`` replicated.  ``reduction``
    (``"mean"`` or ``"sum"``) is the loss's own; ``donate`` is accepted and
    ignored, as in ``optimizer.make_hf_step``.  Batch statistics are the
    whole batch's (module docstring)."""
    return _dp_step(fns, config, ravel, mesh, axis_name, precond_exponent,
                    reduction, batch_stats=True)


def _synced(fn, mesh, axis_name: str, batch_stats: bool, reduction: str):
    """``fn`` run with the data axis as the forward's batch axis, over
    which the ranks' losses combine by ``reduction``, when ``batch_stats``
    (the GSPMD names); as it is otherwise."""
    if not batch_stats:
        return fn
    axis = collectives.mesh_axis(mesh, axis_name)

    def synced(*args, **kwargs):
        with collectives.axes(batch=axis, batch_reduction=reduction):
            return fn(*args, **kwargs)

    return synced


def _dp_step(fns, config, ravel, mesh, axis_name, precond_exponent,
             reduction, batch_stats):
    reduce = _Reduce(mesh, axis_name, reduction)

    def step(params, state, batch, precond_diag=None):
        precond_diag, use_precond = precond_arg(precond_diag, ravel)
        return _hf_step(
            params, state, batch, fns=fns, config=config, ravel=ravel,
            precond_diag=precond_diag if use_precond else None,
            precond_exponent=precond_exponent, reduce=reduce,
        )

    return _synced(step, mesh, axis_name, batch_stats, reduction)


def make_dp_hf_step_shardmap(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
    reduction: str = "mean",
    precond_exponent: float = 0.75,
):
    """The JAX package's explicit ``shard_map`` step: :func:`make_dp_hf_step`
    with each rank's batch statistics its own rows' (module docstring)."""
    return _dp_step(fns, config, ravel, mesh, axis_name, precond_exponent,
                    reduction, batch_stats=False)


def make_dp_hf_train_loop(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
    precond_exponent: float = 0.75,
    donate: bool = False,
    precond_ema_decay: Optional[float] = None,
    reduction: str = "mean",
):
    """Data-parallel ``optimizer.make_hf_train_loop``: the same signature
    and return, with ``batches`` leaves ``[T, N / ranks, ...]`` (this rank's
    rows of every step's batch) and every step a :func:`make_dp_hf_step`
    step.  With ``precond_ema_decay``, each step's diagonal is
    :func:`dp_diag_EF`'s, so the EMA stays replicated."""
    return _synced(
        _train_loop(fns, config, ravel, precond_exponent, precond_ema_decay,
                    _Reduce(mesh, axis_name, reduction)),
        mesh, axis_name, batch_stats=True, reduction=reduction)


def make_dp_hf_acc_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
    reduction: str = "mean",
    precond_exponent: float = 0.75,
    mvp_amortize: bool = False,
):
    """Accumulation x data parallelism: ``step(params, state, loss_data,
    precond_diag=None)`` with ``loss_data`` a stacked datalist of this
    rank's rows (``(xs [C, N / ranks, ...], ys [C, N / ranks, ...])``).
    Each rank accumulates its chunks as ``optimizer.hf_acc_step`` does,
    and one reduction follows the chunk sum: one param-sized ``all_reduce``
    per matvec, not one per chunk.  Batch statistics are each chunk's
    over every rank's rows (module docstring)."""
    return _dp_acc_step(fns, config, ravel, mesh, axis_name, reduction,
                        precond_exponent, mvp_amortize, batch_stats=True)


def _dp_acc_step(fns, config, ravel, mesh, axis_name, reduction,
                 precond_exponent, mvp_amortize, batch_stats):
    reduce = _Reduce(mesh, axis_name, reduction)

    def step(params, state, loss_data, precond_diag=None):
        if not acc._is_stacked(loss_data):
            raise ValueError(
                "make_dp_hf_acc_step requires a STACKED datalist "
                "(xs [C, N, ...], ys [C, N, ...]); see "
                "accumulate.pad_ragged_datalist for ragged chunks."
            )
        precond_diag, use_precond = precond_arg(precond_diag, ravel)
        return _hf_acc_step(
            params, state, fns=fns, config=config, ravel=ravel,
            loss_data=loss_data, reduction=reduction,
            precond_diag=precond_diag if use_precond else None,
            precond_exponent=precond_exponent, mvp_amortize=mvp_amortize,
            reduce=reduce,
        )

    return _synced(step, mesh, axis_name, batch_stats, reduction)


def make_dp_hf_acc_step_shardmap(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
    reduction: str = "mean",
):
    """The JAX package's explicit ``shard_map`` accumulated step:
    :func:`make_dp_hf_acc_step` with each rank's batch statistics its own
    rows' (module docstring)."""
    return _dp_acc_step(fns, config, ravel, mesh, axis_name, reduction,
                        0.75, False, batch_stats=False)


def dp_diag_EF(
    fns: HFModelFns,
    params,
    inputs,
    targets,
    reduction: str,
    ravel: TrainableRavel,
    mesh,
    axis_name: str = "data",
):
    """Empirical-Fisher diagonal over the ranks' rows (``inputs`` and
    ``targets`` are this rank's, in equal shares).

    The diagonal is a per-sample reduction (``sum_i g_i^2``, reference
    preconditioners.py:17-20): each rank sums the squares of its rows'
    gradients (``diag_EF`` with ``"sum"``), one ``all_reduce`` adds the
    partial sums, and ``"mean"`` divides by the global row count.  With
    ``fns.loss_reg``, every per-sample gradient holds the regularizer's
    gradient, computed alike on every rank from the replicated parameters.
    Returns the ``[ravel.dim]`` diagonal, replicated.
    """
    return _diag(fns, params, inputs, targets, reduction, ravel,
                 _Reduce(mesh, axis_name, "sum"))
