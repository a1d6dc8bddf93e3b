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
  iteration (``ops.cg``).
- **Parameters are replicated unless a spec shards them.**  A sharded
  leaf (``param_specs``) is kept as this rank's block between steps
  (:func:`~.mesh.shard_leaf`).  Inside the step every leaf that the
  forward partitions is held as this rank's block of it, the block the
  forward computes with, and every other leaf whole (gathered at the
  step's entry through :func:`~.mesh.unshard_leaf` when a spec shards
  it).  The plan learns the blocks from the model: a forward on whole
  ``meta`` leaves, once per plan, records where each leaf is read
  (:func:`~.collectives.leaf_block`) and which roles split; the step then
  passes the blocks, names those roles and the blocks' shapes to the
  forward (:func:`~.collectives.axes`' ``tensor_leaves`` and
  ``block_shapes``), and a role split in some places only is computed
  whole, its leaves whole.  The flat space reaches the
  rank's local tree through :class:`~.layout.LocalLayout`: each matvec
  lays its direction out to the local tree with one all-to-all over the
  model axis and its product back to the rank's flat block with another,
  a batched sweep lays out its ``[k, n / M]`` rows at once before its
  ``vmap``, and the trial losses, the line search and the update run on
  the rank's block.  No rank builds a whole ``[n]`` flat vector, nor a
  whole partitioned leaf, but a ``loss_reg``: a function of the whole
  tree, it sees the split leaves gathered
  (:meth:`~.layout.LocalLayout.whole`).  Between steps the builders
  return each sharded leaf as the spec's block (the JAX package's
  layout); a block the forward reads otherwise (the fused ``qkv``'s
  strided heads) is moved between the two in one all-to-all at the
  step's entry and one at its exit.
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
  gathered.  Beside such blocks, the spec decides leaf by leaf for the
  embeddings and the head: ``embed`` and ``pos`` under ``P(None, model)``
  are looked up on the rank's ``d / M`` feature columns (and the tied
  head contracts those columns, with one sum of the partial logits), a
  head whose ``w`` is under ``P(None, model)`` and ``b`` under
  ``P(model)`` computes the rank's ``C / M`` classes; the stream and the
  classes are gathered over the axis into whole values
  (:mod:`~..models.transformer`).  A leaf under ``P()`` is computed whole.
- **The MLP's column layout** (tests/test_sharded.py:138-168: every entry
  of a list ``layers`` with ``w`` under ``P(None, model)`` and ``b`` under
  ``P(model)``) sets the tensor axis too: each rank computes every
  layer's ``d_out / M`` output columns on its blocks and gathers them
  over the axis (:mod:`~..models.mlp`), each layer a role of its own.
- Still gathered at the step's entry and computed whole on every rank: a
  sub-layer, layer or leaf whose head count, ``d_ff``, ``d``, output
  width or class count the axis does not divide; stacked blocks
  (:func:`~..models.transformer.stack_blocks`, the pipeline's layout).
- **Context and expert parallelism.**  Under ``batch_specs`` that split
  the sequence axis of the tokens over the model axis (context
  parallelism, CP), the decoders' attention gathers keys and values over
  it and each rank's loss is its positions' share
  (:mod:`~..models.transformer`); the MoE LM's feed-forward gathers the
  positions and routes them as the whole program does
  (:mod:`~..models.moe`).  This is the joined program: its collectives
  run inside the transforms (:mod:`.collectives`), and the loss, the
  gradient, every matvec and every trial loss are summed over the model
  axis outside them; the empirical-Fisher diagonal makes each sample's
  gradient whole over the model axis in the same way, in chunks of rows,
  before it squares the rank's block (``optimizer._diag``).  Under
  ``param_specs`` whose :class:`~.mesh.ExpertSpec` leaves split the
  experts over the model axis (:func:`~..models.moe.moe_param_specs`;
  expert parallelism, EP), each rank runs the MoE feed-forward on its own
  experts and one ``all_reduce`` per layer sums the combine; plain specs
  on the same leaves gather them like any sharded leaf.  Without a
  sequence split EP is one replicated program, as the Megatron blocks
  are: every rank's loss is the whole loss, and the model axis reduces
  nothing.  Under CP + EP it is the joined program's.
- **Where roles meet on one model axis.**  The replicated roles compose:
  Megatron attention beside EP sets the tensor and the expert axes, each
  rank computing its heads and its experts.  CP + EP partitions both:
  the attention runs over the rank's positions and the MoE feed-forward
  over every position on the rank's experts.  Megatron blocks beside CP
  are computed gathered (no tensor axis) and the sequence stays split:
  Megatron's ``copy_to_axis`` / ``reduce_from_axis`` follow one
  replicated program whose sub-layers all receive the same cotangent,
  which the joined program's loss shares do not give.  Megatron-specced
  weights are still kept as blocks between steps, and gathered at the
  step's entry.
- **The data axis** reduces as in :mod:`.data_parallel` when a batch leaf
  is split over it, and the forward takes batch statistics over it
  (``models.resnet.batchnorm``) and routes the MoE LM's tokens over every
  rank's rows (``models.moe``), as GSPMD does.

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
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import accumulate as acc
from ..config import HFConfig, precision_ctx
from ..ops.precond import EMADiag, _pairwise_sum, _reg_grad, _sample_grads
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
from .layout import LocalLayout, move_blocks, narrow_block
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


def _megatron_leaves(specs, params, model_axis: str) -> frozenset:
    """The leaves outside the blocks that the Megatron layout splits over
    the model axis (tests/test_sharded.py:316-331): ``embed`` and ``pos``
    under ``P(None, model)``, and ``head`` when its ``w`` is under
    ``P(None, model)`` and its ``b`` under ``P(model)``."""
    col = (None, model_axis)
    leaves = {name for name in ("embed", "pos")
              if name in params and tuple(specs[name] or ()) == col}
    head = specs.get("head")
    if isinstance(head, dict) and tuple(head.get("w") or ()) == col \
            and tuple(head.get("b") or ()) == (model_axis,):
        leaves.add("head")
    return frozenset(leaves)


def _mlp_columns(specs, params, model_axis: str) -> frozenset:
    """The roles ``"layers.{i}"`` of an MLP's layers (a list ``layers`` of
    dicts with ``w`` and ``b``) when every layer is in the column layout
    of tests/test_sharded.py:138-168 (``w`` under ``P(None, model)``,
    ``b`` under ``P(model)``), else none: the forward then computes each
    layer's output columns on the rank (:mod:`~..models.mlp`)."""
    layers = params.get("layers") if isinstance(params, dict) else None
    if not isinstance(layers, list) or not layers:
        return frozenset()
    col, bias = (None, model_axis), (model_axis,)
    for spec, layer in zip(specs["layers"], layers):
        if not (isinstance(layer, dict) and set(layer) == {"w", "b"}
                and tuple(spec["w"] or ()) == col
                and tuple(spec["b"] or ()) == bias):
            return frozenset()
    return frozenset(f"layers.{i}" for i in range(len(layers)))


def _splits_experts(specs, model_axis: str) -> bool:
    """Whether an :class:`~.mesh.ExpertSpec` of the spec tree splits its
    experts over the model axis (:func:`~..models.moe.moe_param_specs`)."""
    return any(isinstance(s, ExpertSpec) and s and s[0] is not None
               and model_axis in _names(s[0]) for s in _spec_leaves(specs))


# per-sample gradient rows reduced over the model axis at a time
_ROW_CHUNK_BYTES = 256 * 2**20


class _AxesReduce:
    """``reduce`` of the optimizer's steps over both axes: the model axis
    first (the sum of the ranks' shares, under context parallelism),
    then the data axis (:class:`~.data_parallel._Reduce`).  Called on a
    value (a loss, a vector of trial losses); a data term's tree goes to
    :meth:`ravel` instead, which sums the ranks' shares in the local
    layout's all-to-all.  :meth:`sum` and :attr:`size` are the data
    axis's."""

    def __init__(self, data: Optional[_Reduce], model):
        self.data, self.model = data, model

    def _model_rows(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.model.group)
        return out

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.model is not None:
            t = self._model_rows(t)
        return t if self.data is None else self.data(t)

    def ravel(self, tree, ravel) -> torch.Tensor:
        """This rank's flat block of the data term's local ``tree``
        through the step's ``ravel``: under the joined program every
        rank's share added at the entry's owner
        (:meth:`~.layout.LocalLayout.ravel`), then reduced over the data
        axis."""
        flat = ravel.ravel(tree) if self.model is None \
            else ravel.ravel(tree, combine=True)
        return flat if self.data is None else self.data(flat)

    @property
    def size(self):
        return 1 if self.data is None else self.data.size

    def sum(self, t):
        return t if self.data is None else self.data.sum(t)

    def sample_squares(self, diag, fns, params, inputs, targets, ravel):
        """This rank's block of ``sum_i (g_i + reg)^2`` over its rows
        (``optimizer._diag``), with ``g_i`` each sample's WHOLE gradient.
        Under context parallelism a rank's per-sample gradients
        (``diag_EF``'s, whatever ``diag``) are its share of it, so they are
        summed over the model axis as they are laid out to the rank's
        block, in chunks of at most
        :data:`_ROW_CHUNK_BYTES` of rows; the regularizer's gradient is
        then added once and the rank squares its block alone.  Without a
        model axis to sum over (one replicated program: Megatron, the
        MLP's columns, expert parallelism alone), the data axis's
        (``diag``'s) sum."""
        if self.model is None:
            return self.data.sample_squares(diag, fns, params, inputs,
                                            targets, ravel)
        leaves, treedef = tree_flatten(_sample_grads(
            fns.model_fn, fns.loss_outer, params, inputs, targets))
        reg = _reg_grad(fns.loss_reg, params, ravel)
        step = max(1, _ROW_CHUNK_BYTES // (ravel.block * ravel.dtype.itemsize))
        out = 0
        for i in range(0, leaves[0].shape[0], step):
            g = ravel.ravel(tree_unflatten(
                treedef, [a[i:i + step] for a in leaves]), combine=True)
            if reg is not None:
                g = g + reg
            out = out + _pairwise_sum(g ** 2)
        return out


class _Entered(NamedTuple):
    """What a builder's step runs on (:meth:`_Plan.enter`)."""

    params: Any  # the local tree
    batch: Any  # this rank's part of the batch
    axes: dict  # of the forward (collectives.axes)
    reduce: Optional[_AxesReduce]
    ravel: Any  # the LocalLayout, or the TrainableRavel on one model rank
    fns: HFModelFns  # a loss_reg seeing whole leaves


class _Plan:
    """What the three builders share: the checks of the JAX package's
    ``_prepare``, the hooks, the parameter placement, and per batch the
    axes of the forward, the reduction and the local layout."""

    def __init__(self, fns, config, ravel, mesh, data_axis, model_axis,
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
        self.fns, self.config, self.ravel, self.mesh = fns, config, ravel, \
            mesh
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
        self._layouts = {}  # per role of the model axis

    # -- parameters and state ------------------------------------------

    def _resolve(self, params):
        if self._specs is None:
            self._specs = _param_shardings(self.mesh, params,
                                           self.param_specs)
            self.experts = _splits_experts(self._specs, self.model_axis)
            megatron = self.model.size > 1 and _megatron(
                self._specs, params, self.model_axis)
            columns = _mlp_columns(self._specs, params, self.model_axis) \
                if self.model.size > 1 else frozenset()
            # whether the specs split work over the tensor axis, and the
            # roles outside the transformer blocks that they split
            self.tensor = megatron or bool(columns)
            self.tensor_leaves = columns | (_megatron_leaves(
                self._specs, params, self.model_axis) if megatron
                else frozenset())
        return self._specs

    def _spec_blocks(self, spec, shape):
        """Every rank's block ``(dim, starts, length)`` of a leaf of
        ``shape`` under ``spec`` when the spec splits one dimension over
        the model axis alone, else ``None``."""
        split = [(d, _names(part)) for d, part in enumerate(spec or ())
                 if part is not None]
        if len(split) != 1 or split[0][1] != (self.model_axis,):
            return None
        dim = split[0][0]
        k = shape[dim] // self.model.size
        return [(dim, (r * k,), k) for r in range(self.model.size)]

    def _local(self, params, layout):
        """The local tree of ``params`` (whole, or as a step returned them:
        each sharded leaf the spec's block).  A leaf the step computes
        whole is gathered; a block the spec holds otherwise than the
        forward reads it (the fused ``qkv``'s strided heads) is moved in
        one all-to-all for all such leaves."""
        leaves, treedef = tree_flatten(params)
        out, moves = list(leaves), []
        me = self.model.rank
        for i, (x, spec) in enumerate(zip(leaves,
                                          _spec_leaves(self._specs))):
            shape = self.ravel._shapes[i]
            compute = layout.blocks.get(i) if layout is not None else None
            if tuple(x.shape) == shape:
                out[i] = x if compute is None else narrow_block(x, compute)
                continue
            held = self._spec_blocks(spec, shape)
            if compute is not None and held is not None \
                    and held[me][0] == compute[0]:
                if held[me] != compute:
                    moves.append((i, held, layout.all_blocks))
                continue
            whole = unshard_leaf(x, spec, self.mesh)
            out[i] = whole if compute is None \
                else narrow_block(whole, compute)
        return tree_unflatten(treedef, self._move(out, moves))

    def _move(self, leaves, moves, back=False):
        if not moves:
            return leaves
        index = [i for i, _, _ in moves]
        held = [h for _, h, _ in moves]
        compute = [[b[i] for b in blocks] for i, _, blocks in moves]
        src, dst = (compute, held) if back else (held, compute)
        moved = move_blocks([leaves[i] for i in index], src, dst, self.model)
        for i, t in zip(index, moved):
            leaves[i] = t
        return leaves

    def leave(self, params, ravel):
        """The local tree ``params`` as the builders return it: each leaf
        a spec shards as this rank's block of the spec (the JAX package's
        layout), every other leaf whole."""
        layout = ravel if isinstance(ravel, LocalLayout) else None
        leaves, treedef = tree_flatten(params)
        out, moves = list(leaves), []
        me = self.model.rank
        for i, (x, spec) in enumerate(zip(leaves,
                                          _spec_leaves(self._specs))):
            if spec is None:
                continue
            compute = layout.blocks.get(i) if layout is not None else None
            if compute is None:
                out[i] = shard_leaf(x, spec, self.mesh)
                continue
            held = self._spec_blocks(spec, self.ravel._shapes[i])
            if held is not None and held[me][0] == compute[0]:
                if held[me] != compute:
                    moves.append((i, held, layout.all_blocks))
                continue
            out[i] = shard_leaf(layout.whole_leaf(i, x), spec, self.mesh)
        return tree_unflatten(treedef, self._move(out, moves, back=True))

    def place_state(self, state):
        return state._replace(x0=self.shard(state.x0))

    def precond(self, precond_diag):
        precond_diag, use = precond_arg(precond_diag, self.ravel)
        return self.shard(precond_diag) if use else None

    # -- the local layout -------------------------------------------------

    def _layout(self, axes, batch):
        """``(LocalLayout, what the forward's axes add)`` for the forward's
        ``axes``, recorded once per role of the model axis: the roles
        split over the tensor axis and, per role, the shapes of the blocks
        that the forward receives (:func:`~.collectives.axes`)."""
        key = tuple(axes[k] is not None
                    for k in ("sequence", "expert", "tensor"))
        if key not in self._layouts:
            if axes["tensor"] is None and axes["expert"] is None:
                self._layouts[key] = (LocalLayout(
                    self.ravel, self.model, [{}] * self.model.size), {})
                return self._layouts[key]
            blocks, roles, leaf_roles = self._record(axes, batch)
            layout = LocalLayout(self.ravel, self.model, blocks)
            shapes = {}
            for i, role in leaf_roles.items():
                shapes.setdefault(role, set()).add(layout.shapes[i])
            self._layouts[key] = (layout, dict(tensor_leaves=roles,
                                               block_shapes=shapes))
        return self._layouts[key]

    def _record(self, axes, batch):
        """Every rank's block of each leaf and the roles split over the
        tensor axis, from the model itself: its forward on whole ``meta``
        leaves under ``axes`` with the model axis's rank set to each rank
        in turn (:func:`~.collectives.recording`).  A role that the
        forward splits in one place and not in another (blocks of
        different widths) is computed whole, and its leaves stay whole.
        Returns every rank's blocks, the split roles and each split leaf's
        role."""
        shapes, dtypes = self.ravel._shapes, self.ravel._dtypes
        leaves = [torch.empty(s, dtype=d, device="meta")
                  for s, d in zip(shapes, dtypes)]
        params = tree_unflatten(self.ravel._treedef, leaves)
        if self.stacked:
            batch = tree_map(lambda a: a[0], batch)
        batch = tree_map(lambda a: a.to("meta")
                         if isinstance(a, torch.Tensor) else a, batch)
        recs = []
        for r in range(self.model.size):
            ax = {k: v._replace(rank=r) if k in ("sequence", "expert",
                                                 "tensor") and v is not None
                  else v for k, v in axes.items()}
            with torch.no_grad(), collectives.axes(**ax), \
                    collectives.recording(leaves) as rec:
                self.fns.data_loss(params, batch)
            recs.append(rec)
        seen = recs[0].roles
        split = frozenset(role for role, s in seen.items() if s == {True})
        keep = [i for i, role in recs[0].leaf_roles.items()
                if seen.get(role, {True}) == {True}]
        return ([{i: rec.blocks[i] for i in keep} for rec in recs], split,
                {i: recs[0].leaf_roles[i] for i in keep})

    # -- per batch --------------------------------------------------------

    def enter(self, params, batch) -> _Entered:
        """Everything one call runs on: the local tree of ``params``, this
        rank's part of ``batch``, the forward's axes, the reduction, the
        layout (``ravel``) and the model functions."""
        self._resolve(params)
        specs = _batch_specs(batch, self.batch_specs, self.default_s,
                             self.stacked)
        seq_dims = _split_dims(specs, self.model_axis, self.stacked)
        if 0 in seq_dims:
            raise ValueError(
                "The model axis may split the sequence axis of the batch "
                "(dimension 1), not its rows; split the rows over the data "
                "axis."
            )
        # the sequence split is the one joined program's role of the model
        # axis; beside it the tensor-split leaves are computed gathered
        context = bool(seq_dims)
        data_split = self.data_axis is not None and 0 in _split_dims(
            specs, self.data_axis, self.stacked)
        tensor = self.tensor and not context
        axes = dict(
            batch=collectives.mesh_axis(self.mesh, self.data_axis)
            if data_split else None,
            sequence=self.model if context else None,
            expert=self.model if self.experts else None,
            tensor=self.model if tensor else None,
            batch_reduction=self.reduction,
            tensor_leaves=self.tensor_leaves if tensor else frozenset(),
        )
        local = _place_batch(self.mesh, batch, self.batch_specs,
                             self.default_s, self.stacked)
        # a data axis of one rank has nothing to reduce
        data = _Reduce(self.mesh, self.data_axis, self.reduction) \
            if data_split and axes["batch"].size > 1 else None
        model = self.model if context and self.model.size > 1 else None
        fns, ravel, layout = self.fns, self.ravel, None
        if self.model.size > 1:
            layout, extra = self._layout(axes, local)
            ravel = layout
            axes.update(extra)
            if layout.split:
                if fns.loss_reg is not None:
                    reg = fns.loss_reg
                    fns = fns._replace(
                        loss_reg=lambda p: reg(layout.whole(p)))
        reduce = None
        if data is not None or model is not None:
            reduce = _AxesReduce(data, model)
        return _Entered(self._local(params, layout), local, axes, reduce,
                        ravel, fns)


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
    plan = _Plan(fns, config, ravel, mesh, data_axis, model_axis,
                 param_specs, batch_specs, reduction, stacked=False)

    def step(params, state, batch, precond_diag=None):
        e = plan.enter(params, batch)
        with collectives.axes(**e.axes):
            params, state, stats = _hf_step(
                e.params, plan.place_state(state), e.batch, fns=e.fns,
                config=plan.config, ravel=e.ravel,
                precond_diag=plan.precond(precond_diag),
                precond_exponent=precond_exponent, reduce=e.reduce,
                shard_vec=plan.shard, shard_buf=plan.shard,
            )
        return plan.leave(params, e.ravel), state, stats

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
    plan = _Plan(fns, config, ravel, mesh, data_axis, model_axis,
                 param_specs, batch_specs, reduction, stacked=True)

    def step(params, state, loss_data, precond_diag=None):
        if not acc._is_stacked(loss_data):
            raise ValueError(
                "make_sharded_hf_acc_step requires a STACKED datalist "
                "(xs [C, N, ...], ys [C, N, ...]); see "
                "accumulate.pad_ragged_datalist for ragged chunks."
            )
        e = plan.enter(params, loss_data)
        with collectives.axes(**e.axes):
            params, state, stats = _hf_acc_step(
                e.params, plan.place_state(state), fns=e.fns,
                config=plan.config, ravel=e.ravel, loss_data=e.batch,
                reduction=reduction, precond_diag=plan.precond(precond_diag),
                precond_exponent=precond_exponent,
                mvp_amortize=mvp_amortize, reduce=e.reduce,
                shard_vec=plan.shard, shard_buf=plan.shard,
            )
        return plan.leave(params, e.ravel), state, stats

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
    (each sample's gradient whole over the model axis, its square summed
    over the data axis, kept as this rank's block) preconditions every
    solve; the loop then takes and returns it,
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
    plan = _Plan(fns, config, ravel, mesh, data_axis, model_axis,
                 param_specs, batch_specs, reduction, stacked=True)

    def loop(params, state, batches, ema_state=None):
        if use_ema and ema_state is None:
            ema_state = EMADiag(precond_ema_decay)
        e = plan.enter(params, batches)
        params, state = e.params, plan.place_state(state)
        num_steps = tree_flatten(e.batch)[0][0].shape[0]
        per_step = []
        with collectives.axes(**e.axes):
            for i in range(num_steps):
                batch = tree_map(lambda a: a[i], e.batch)
                precond_diag = None
                if use_ema:
                    inputs, targets = batch
                    with precision_ctx(plan.config):
                        d = _diag(e.fns, params, inputs, targets,
                                  plan.config.precond_reduction, e.ravel,
                                  e.reduce)
                    precond_diag = ema_state.update(plan.shard(d))
                params, state, stats = _hf_step(
                    params, state, batch, fns=e.fns, config=plan.config,
                    ravel=e.ravel, precond_diag=precond_diag,
                    precond_exponent=precond_exponent, reduce=e.reduce,
                    shard_vec=plan.shard, shard_buf=plan.shard,
                )
                per_step.append(stats)
        out = (plan.leave(params, e.ravel), state, _stack_stats(per_step))
        return out + (ema_state,) if use_ema else out

    return loop
