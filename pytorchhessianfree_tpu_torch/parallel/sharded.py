"""Solver-state-sharded Hessian-free steps over a 2-D (data x model) mesh
(port of :mod:`pytorchhessianfree_tpu.parallel.sharded`).

The reference keeps the CG iterate grid (reference cg.py:152-170, a
``len(grid) x n_params`` list of vectors) whole on one GPU.  Every CG
operation is elementwise over the flat ``[n]`` vectors or a dot product,
so splitting the vectors over a ``model`` mesh axis splits the solver's
working set across the ranks, with one ``all_reduce`` per dot product: the
ZeRO/FSDP form of a second-order solver.  The batch splits over ``data``
as in :mod:`.data_parallel`.

The JAX package annotates shardings and lets GSPMD partition the
unchanged single-device step.  The port's ranks are processes, so the
port states what GSPMD chose freely:

- **The flat space is split in contiguous blocks.**  Rank ``m`` of the
  model axis holds entries ``[m n / M, (m + 1) n / M)`` of the gradient,
  the iterate, the residual, the direction, its product, the warm start in
  ``state.x0``, the preconditioner diagonal and every row of the
  ``[rows, n]`` iterate grid (:class:`ModelShard`; the grid's layout is
  forced to ``"rows"``, as in the JAX package).  Each dot product reduces
  over the model axis; the CG kernel runs on the rank's block and its
  partial ``m`` and ``r.r`` are reduced together, two values per
  iteration (``ops.cg``).  Each matvec gathers its direction (``n``),
  runs the whole-vector matvec and keeps its block; each trial loss
  gathers its step.  The chosen step is gathered once, and the line
  search and the update run on whole vectors, alike on every rank.
- **Parameters are replicated unless a spec shards them.**  A sharded
  leaf (``param_specs``) is kept as this rank's block between steps
  (:func:`~.mesh.shard_leaf`) and enters the step through an
  ``all_gather`` (:func:`~.mesh.unshard_leaf`), so the step and its flat
  space see whole weights.  The forward's compute on a gathered leaf is
  replicated over the model axis, but for the Megatron layout below.
- **Megatron tensor parallelism splits the transformer blocks' work.**
  When every block of a list ``blocks`` of the parameter tree is in the
  Megatron layout of tests/test_sharded.py:316-331 in each sub-layer it
  has (attention: ``qkv.w`` under ``P(None, model)`` and ``proj.w`` under
  ``P(model, None)``; MLP: ``ff1.w`` under ``P(None, model)`` and
  ``ff2.w`` under ``P(model, None)``), the step sets the model axis as the
  forward's tensor axis, one flag for the whole tree: each rank computes
  its ``H / M`` heads and its ``d_ff / M`` feed-forward columns, with one
  sum over the axis per sub-layer inside the forward
  (:mod:`~..models.transformer`), under every derivative the optimizer
  takes.  The loss stays whole and alike on every rank, as GSPMD's
  partitioned forward gives it.  The specs decide, not the leaf names
  alone: a tree in which some block lacks the layout is computed
  gathered.
  Still gathered and computed whole on every rank: the embeddings,
  ``pos`` and the head (a vocab-parallel head is not ported); a sub-layer
  whose head count or ``d_ff`` the axis does not divide; stacked blocks
  (:func:`~..models.transformer.stack_blocks`, the pipeline's layout).
  The step refuses the layout together with context or expert
  parallelism over the same model axis.
- **Two more partitioned forms.**  Under ``batch_specs`` that
  split the sequence axis of the tokens over the model axis (context
  parallelism), the decoders' attention gathers keys and values over it
  and each rank's loss is its positions' share
  (:mod:`~..models.transformer`).  Under ``param_specs`` whose
  :class:`~.mesh.ExpertSpec` leaves split the experts over the model axis
  (:func:`~..models.moe.moe_param_specs`; expert parallelism), each rank
  runs the MoE feed-forward on its own experts and one ``all_reduce`` per
  layer sums the combine (:mod:`~..models.moe`); plain specs on the same
  leaves gather them like any sharded leaf.  Both run their collectives inside the
  transforms (:mod:`.collectives`); the loss, the gradient, every matvec
  and every trial loss are then summed over the model axis (context) or
  averaged over it (experts: each rank's loss is the whole loss), outside
  the transforms.
- **The data axis** reduces as in :mod:`.data_parallel` when a batch leaf
  is split over it, and the forward takes batch statistics over it
  (``models.resnet.batchnorm``), as GSPMD does.

Every branch on the host reads a reduced or replicated value, so the
replicas along both axes stay bitwise equal.  Trajectories equal the
single-process step up to reduction order.

The builders take this rank's view of the inputs: ``params`` whole (or as
a previous step returned them), ``state.x0`` whole or as this rank's
block, and the whole batch, which they cut per ``batch_specs``.  They
return the parameters with sharded leaves as this rank's blocks and
``state.x0`` as this rank's block.  The loss's reduction over the data
axis is a keyword (``reduction``), as in :mod:`.data_parallel`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from .. import accumulate as acc
from ..config import HFConfig, precision_ctx
from ..ops.precond import EMADiag
from ..optimizer import (
    HFModelFns,
    _diag,
    _hf_acc_step,
    _hf_step,
    _stack_stats,
    precond_arg,
)
from ..utils.flatten import (
    TrainableRavel,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from . import collectives, distributed
from .data_parallel import _Reduce
from .mesh import (
    ExpertSpec,
    PartitionSpec,
    _names,
    shard_leaf,
    unshard_leaf,
)

P = PartitionSpec


class ModelShard:
    """The port's ``shard_vec`` / ``shard_buf``: this rank's contiguous
    block of the last axis of a flat ``[n]`` vector or ``[rows, n]``
    buffer, over the model axis.  A vector that is already a block passes
    unchanged.  :meth:`gather` joins the blocks; on an axis of more than
    one rank, ``dot`` and ``sum`` reduce over it (``ops.cg``)."""

    def __init__(self, axis: collectives.Axis, n: int):
        if n % axis.size:
            raise ValueError(f"{n} does not divide over {axis.size} ranks")
        self.axis, self.n = axis, n
        self.block = n // axis.size
        self.start = axis.rank * self.block
        if axis.size > 1:
            self.dot = self._dot
            self.sum = self._sum

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        if v.shape[-1] == self.block:
            return v
        if v.shape[-1] != self.n:
            raise ValueError(
                f"expected a last axis of {self.n} or its block "
                f"{self.block}, got {tuple(v.shape)}"
            )
        return v[..., self.start:self.start + self.block].clone(
            memory_format=torch.contiguous_format)

    def gather(self, v: torch.Tensor) -> torch.Tensor:
        if self.axis.size == 1:
            return v
        return collectives._gather(v.contiguous(), self.axis, v.dim() - 1)

    def _dot(self, a, b):
        return collectives._reduce(torch.dot(a, b), self.axis)

    def _sum(self, t):
        return collectives._reduce(t, self.axis)


def _is_spec(x) -> bool:
    return x is None or isinstance(x, PartitionSpec)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in the order of ``tree_flatten``'s leaves
    (a spec is a tuple, which ``tree_flatten`` would descend into)."""
    if _is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    return [s for sub in specs for s in _spec_leaves(sub)]


def _expand(specs, tree, fn=lambda spec: spec):
    """A tree prefix of specs broadcast over ``tree``: one spec (or
    ``None``), passed through ``fn``, per leaf.  A spec at an interior node
    covers its subtree."""
    if _is_spec(specs):
        return tree_map(lambda _: fn(specs), tree)
    if isinstance(specs, dict) and isinstance(tree, dict):
        if set(specs) != set(tree):
            raise ValueError(
                f"spec keys {sorted(specs)} do not match {sorted(tree)}")
        return {k: _expand(specs[k], tree[k], fn) for k in tree}
    if isinstance(specs, (list, tuple)) and isinstance(tree, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(
                f"{len(specs)} specs for a node of {len(tree)} children")
        out = [_expand(s, t, fn) for s, t in zip(specs, tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    raise ValueError(f"spec tree does not prefix the tree at {specs!r}")


def _param_shardings(mesh, params: Any, param_specs: Optional[Any]):
    """One spec per parameter leaf (``None`` = replicated): ``param_specs``
    is ``None``, one :class:`~.mesh.PartitionSpec` for every leaf, or a
    tree prefix of the parameters, as in the JAX package."""
    del mesh  # the JAX signature's; a spec names the mesh's axes
    return _expand(param_specs, params)


def unshard_params(params, param_specs, mesh, ravel: TrainableRavel):
    """The whole parameter tree from this rank's view of it: the tree a
    sharded step returned (its sharded leaves this rank's blocks) or the
    whole tree.  Each leaf that ``param_specs`` shards and that is not
    already whole is gathered (a collective over the axes its spec
    names)."""
    specs = _spec_leaves(_param_shardings(mesh, params, param_specs))
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [
        leaf if spec is None or tuple(leaf.shape) == shape
        else unshard_leaf(leaf, spec, mesh)
        for leaf, spec, shape in zip(leaves, specs, ravel._shapes)
    ])


def _batch_specs(batch, batch_specs, default_s, stacked=False):
    """One spec per batch leaf: ``default_s`` everywhere without
    ``batch_specs``; else a tree prefix of specs in which a ``None`` leaf
    inherits ``default_s`` (``PartitionSpec()`` replicates) and, when
    ``stacked``, each given spec gains a leading unsplit axis."""
    if batch_specs is None:
        return tree_map(lambda _: default_s, batch)

    def resolve(spec):
        if spec is None:
            return default_s if default_s is not None else P()
        return P(None, *spec) if stacked else spec

    return _expand(batch_specs, batch, resolve)


def _place_batch(mesh, batch, batch_specs, default_s, stacked=False):
    """This rank's part of the whole ``batch`` under the specs of
    :func:`_batch_specs`, on the rank's device (cut before the copy)."""
    specs = _batch_specs(batch, batch_specs, default_s, stacked)
    device = distributed.rank_device()
    leaves, treedef = tree_flatten(batch)
    placed = [
        shard_leaf(torch.as_tensor(x), s, mesh).to(device)
        if hasattr(x, "shape") else x
        for x, s in zip(leaves, _spec_leaves(specs))
    ]
    return tree_unflatten(treedef, placed)


def _split_dims(specs, axis_name: str, stacked: bool):
    """The dimensions (past the stacking axis) that some spec splits over
    ``axis_name``."""
    skip = 1 if stacked else 0
    dims = set()
    for spec in _spec_leaves(specs):
        for dim, part in enumerate(spec or ()):
            if part is not None and axis_name in _names(part):
                dims.add(dim - skip)
    return dims


def _megatron(specs, params, model_axis: str) -> bool:
    """Whether the parameters hold transformer blocks (a list ``blocks`` of
    per-layer dicts, each with ``qkv`` and ``proj`` or ``ff1`` and
    ``ff2``), each in the Megatron layout in every sub-layer it has:
    ``qkv.w`` and ``ff1.w`` split by column over the model axis, ``proj.w``
    and ``ff2.w`` by row (module docstring)."""
    layout = (P(None, model_axis), P(model_axis, None))
    blocks = params.get("blocks") if isinstance(params, dict) else None
    if not isinstance(blocks, list) or not blocks:
        return False
    for spec, blk in zip(specs["blocks"], blocks):
        pairs = [pair for pair in (("qkv", "proj"), ("ff1", "ff2"))
                 if isinstance(blk, dict) and pair[0] in blk
                 and pair[1] in blk]
        if not pairs or any(
                tuple(tuple(spec[k]["w"] or ()) for k in pair) != layout
                for pair in pairs):
            return False
    return True


def _splits_experts(specs, model_axis: str) -> bool:
    """Whether an :class:`~.mesh.ExpertSpec` of the spec tree splits its
    experts over the model axis (:func:`~..models.moe.moe_param_specs`)."""
    return any(isinstance(s, ExpertSpec) and s and s[0] is not None
               and model_axis in _names(s[0]) for s in _spec_leaves(specs))


class _AxesReduce:
    """``reduce`` of the optimizer's steps over both axes: the model axis
    first (a sum of the ranks' shares, or the mean of their equal
    values), then the data axis (:class:`~.data_parallel._Reduce`)."""

    def __init__(self, data: Optional[_Reduce], model, mode: str):
        self.data, self.model, self.mode = data, model, mode

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.model is not None:
            out = t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, group=self.model.group)
            t = out / self.model.size if self.mode == "mean" else out
        return t if self.data is None else self.data(t)

    @property
    def size(self):
        return self.data.size

    def sum(self, t):
        if self.model is not None:
            raise ValueError(
                "an empirical-Fisher diagonal needs each sample's whole "
                "gradient; under context or expert parallelism a rank has "
                "its share of it. Compute the diagonal without the model "
                "axis's partitioned forward."
            )
        return self.data.sum(t)


class _Plan:
    """What the three builders share: the checks of the JAX package's
    ``_prepare``, the hooks, the parameter placement, and per batch the
    axes of the forward and the reduction."""

    def __init__(self, config, ravel, mesh, data_axis, model_axis,
                 param_specs, batch_specs, reduction, stacked):
        names = tuple(mesh.mesh_dim_names or ())
        if model_axis not in names:
            raise ValueError(
                f"Mesh {names} has no axis named {model_axis!r}.")
        msize = mesh.size(names.index(model_axis))
        if ravel.dim % msize != 0:
            raise ValueError(
                f"Flat dimension {ravel.dim} is not divisible by the "
                f"{model_axis!r} axis size {msize}; construct the "
                f"TrainableRavel with pad_to_multiple a multiple of {msize} "
                "(the default 1024 covers power-of-two axes)."
            )
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Invalid reduction {reduction}")
        # each stored iterate is a row of a [rows, n] buffer split along n
        if config.cg.buffer_layout != "rows":
            config = dataclasses.replace(
                config,
                cg=dataclasses.replace(config.cg, buffer_layout="rows"))
        self.config, self.ravel, self.mesh = config, ravel, mesh
        self.data_axis = data_axis if data_axis in names else None
        self.model_axis = model_axis
        self.model = collectives.mesh_axis(mesh, model_axis)
        self.shard = ModelShard(self.model, ravel.dim)
        self.param_specs, self.batch_specs = param_specs, batch_specs
        self.reduction, self.stacked = reduction, stacked
        lead = (None,) if stacked else ()
        self.default_s = P(*lead, self.data_axis) if self.data_axis \
            else P()
        self._specs = None  # per parameter leaf, from the first params

    # -- parameters and state ------------------------------------------

    def _resolve(self, params):
        if self._specs is None:
            self._specs = _param_shardings(self.mesh, params,
                                           self.param_specs)
            self.experts = _splits_experts(self._specs, self.model_axis)
            self.megatron = self.model.size > 1 and _megatron(
                self._specs, params, self.model_axis)
        return self._specs

    def whole_params(self, params):
        self._resolve(params)
        return unshard_params(params, self.param_specs, self.mesh,
                              self.ravel)

    def shard_params(self, params):
        specs = _spec_leaves(self._specs)
        leaves, treedef = tree_flatten(params)
        return tree_unflatten(treedef, [
            leaf if s is None else shard_leaf(leaf, s, self.mesh)
            for leaf, s in zip(leaves, specs)
        ])

    def place_state(self, state):
        return state._replace(x0=self.shard(state.x0))

    def precond(self, precond_diag):
        precond_diag, use = precond_arg(precond_diag, self.ravel)
        return self.shard(precond_diag) if use else None

    # -- per batch --------------------------------------------------------

    def place(self, batch):
        """``(local batch, axes of the forward, reduce)``."""
        specs = _batch_specs(batch, self.batch_specs, self.default_s,
                             self.stacked)
        seq_dims = _split_dims(specs, self.model_axis, self.stacked)
        if 0 in seq_dims:
            raise ValueError(
                "The model axis may split the sequence axis of the batch "
                "(dimension 1), not its rows; split the rows over the data "
                "axis."
            )
        context = bool(seq_dims)
        if context and self.experts:
            raise ValueError(
                "Context and expert parallelism over one model axis are "
                "not supported together.")
        if self.megatron and (context or self.experts):
            other = "Context" if context else "Expert"
            raise ValueError(
                f"{other} parallelism and Megatron-partitioned transformer "
                f"blocks (tensor parallelism) over one model axis are not "
                f"supported together.")
        data_split = self.data_axis is not None and 0 in _split_dims(
            specs, self.data_axis, self.stacked)
        data = _Reduce(self.mesh, self.data_axis, self.reduction) \
            if data_split else None
        model = self.model if (context or self.experts) \
            and self.model.size > 1 else None
        reduce = None
        if data is not None or model is not None:
            reduce = _AxesReduce(data, model,
                                 "sum" if context else "mean")
        axes = dict(
            batch=collectives.mesh_axis(self.mesh, self.data_axis)
            if data_split else None,
            sequence=self.model if context else None,
            expert=self.model if self.experts else None,
            tensor=self.model if self.megatron else None,
        )
        local = _place_batch(self.mesh, batch, self.batch_specs,
                             self.default_s, self.stacked)
        return local, axes, reduce


def make_sharded_hf_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    data_axis: Optional[str] = "data",
    model_axis: str = "model",
    param_specs: Optional[Any] = None,
    precond_exponent: float = 0.75,
    donate: bool = False,
    batch_specs: Optional[Any] = None,
    reduction: str = "mean",
):
    """Build the solver-state-sharded HF step over a (data x model) mesh.

    Returns ``step(params, state, batch, precond_diag=None) -> (params,
    state, stats)`` with

    - ``batch`` the whole batch, of which this rank keeps its rows over
      ``data_axis`` (skipped when ``data_axis`` is None or absent from the
      mesh: pure model-axis sharding), or per leaf under ``batch_specs``
      (a tree prefix of :class:`~.mesh.PartitionSpec` / ``None``), e.g.
      tokens ``[N, T]`` under ``P(None, "model")`` or ``P("data",
      "model")`` for context parallelism;
    - every flat CG vector, the iterate grid, ``state.x0`` and
      ``precond_diag`` split over ``model_axis`` (module docstring);
    - parameters replicated, or split per ``param_specs`` (tensor and
      expert parallelism).

    ``ravel.dim`` must be divisible by the ``model_axis`` size.
    ``reduction`` is the loss's (``"mean"`` or ``"sum"``) over the data
    axis; ``donate`` is accepted and ignored, as in
    ``optimizer.make_hf_step``.
    """
    plan = _Plan(config, ravel, mesh, data_axis, model_axis, param_specs,
                 batch_specs, reduction, stacked=False)

    def step(params, state, batch, precond_diag=None):
        params = plan.whole_params(params)
        batch, axes, reduce = plan.place(batch)
        with collectives.axes(**axes):
            params, state, stats = _hf_step(
                params, plan.place_state(state), batch, fns=fns,
                config=plan.config, ravel=ravel,
                precond_diag=plan.precond(precond_diag),
                precond_exponent=precond_exponent, reduce=reduce,
                shard_vec=plan.shard, shard_buf=plan.shard,
            )
        return plan.shard_params(params), state, stats

    return step


def make_sharded_hf_acc_step(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    data_axis: Optional[str] = "data",
    model_axis: str = "model",
    param_specs: Optional[Any] = None,
    reduction: str = "mean",
    precond_exponent: float = 0.75,
    mvp_amortize: bool = False,
    batch_specs: Optional[Any] = None,
):
    """Accumulation x solver-state sharding: ``step(params, state,
    loss_data, precond_diag=None)`` with ``loss_data`` a whole stacked
    datalist ``(xs [C, N, ...], ys [C, N, ...])``, each chunk's rows split
    over ``data_axis`` (N divisible by its size) and the CG space over
    ``model_axis``.  ``batch_specs`` describes ONE chunk's leaves; the
    stacked chunk axis is prepended unsplit."""
    plan = _Plan(config, ravel, mesh, data_axis, model_axis, param_specs,
                 batch_specs, reduction, stacked=True)

    def step(params, state, loss_data, precond_diag=None):
        if not acc._is_stacked(loss_data):
            raise ValueError(
                "make_sharded_hf_acc_step requires a STACKED datalist "
                "(xs [C, N, ...], ys [C, N, ...]); see "
                "accumulate.pad_ragged_datalist for ragged chunks."
            )
        params = plan.whole_params(params)
        loss_data, axes, reduce = plan.place(loss_data)
        with collectives.axes(**axes):
            params, state, stats = _hf_acc_step(
                params, plan.place_state(state), fns=fns,
                config=plan.config, ravel=ravel, loss_data=loss_data,
                reduction=reduction, precond_diag=plan.precond(precond_diag),
                precond_exponent=precond_exponent,
                mvp_amortize=mvp_amortize, reduce=reduce,
                shard_vec=plan.shard, shard_buf=plan.shard,
            )
        return plan.shard_params(params), state, stats

    return step


def make_sharded_hf_train_loop(
    fns: HFModelFns,
    config: HFConfig,
    ravel: TrainableRavel,
    mesh,
    data_axis: Optional[str] = "data",
    model_axis: str = "model",
    param_specs: Optional[Any] = None,
    precond_exponent: float = 0.75,
    donate: bool = False,
    precond_ema_decay: Optional[float] = None,
    batch_specs: Optional[Any] = None,
    reduction: str = "mean",
):
    """Steps of :func:`make_sharded_hf_step` over a whole stacked batch
    (leaves ``[T, N, ...]``): ``loop(params, state, batches) -> (params,
    state, stats)`` with stacked stats.  ``batch_specs`` describes ONE
    step's leaves; the time axis is prepended unsplit.

    ``precond_ema_decay``: an EMA of each step's empirical-Fisher diagonal
    (over the data axis, replicated, then cut to this rank's block)
    preconditions every solve; the loop then takes and returns it,
    ``loop(params, state, batches, ema_state=None) -> (params, state,
    stats, ema_state)``, an :class:`~..ops.precond.EMADiag` holding this
    rank's block."""
    if precond_ema_decay is not None:
        if not 0.0 <= precond_ema_decay < 1.0:
            raise ValueError(f"Invalid decay {precond_ema_decay}")
        if fns.model_fn is None or fns.loss_outer is None:
            raise ValueError(
                "precond_ema_decay requires the split model form "
                "(per-sample gradients need model_fn + loss_outer)."
            )
    use_ema = precond_ema_decay is not None
    plan = _Plan(config, ravel, mesh, data_axis, model_axis, param_specs,
                 batch_specs, reduction, stacked=True)

    def loop(params, state, batches, ema_state=None):
        if use_ema and ema_state is None:
            ema_state = EMADiag(precond_ema_decay)
        params = plan.whole_params(params)
        batches, axes, reduce = plan.place(batches)
        state = plan.place_state(state)
        num_steps = tree_flatten(batches)[0][0].shape[0]
        per_step = []
        with collectives.axes(**axes):
            for i in range(num_steps):
                batch = tree_map(lambda a: a[i], batches)
                precond_diag = None
                if use_ema:
                    inputs, targets = batch
                    with precision_ctx(plan.config):
                        d = _diag(fns, params, inputs, targets,
                                  plan.config.precond_reduction, ravel,
                                  reduce)
                    precond_diag = ema_state.update(plan.shard(d))
                params, state, stats = _hf_step(
                    params, state, batch, fns=fns, config=plan.config,
                    ravel=ravel, precond_diag=precond_diag,
                    precond_exponent=precond_exponent, reduce=reduce,
                    shard_vec=plan.shard, shard_buf=plan.shard,
                )
                per_step.append(stats)
        out = (plan.shard_params(params), state, _stack_stats(per_step))
        return out + (ema_state,) if use_ema else out

    return loop
