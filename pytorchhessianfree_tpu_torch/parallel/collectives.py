"""Differentiable collectives over one axis of a mesh, and the axes that a
model's forward reads.

The JAX package never calls a collective by hand: GSPMD inserts them where
a sharded value meets a replicated one.  The port's ranks are processes,
so a forward that mixes the ranks' values (BatchNorm statistics over the
data axis, attention keys over a sequence split across the model axis,
the combine of experts split across it) calls a collective itself, inside
``torch.func.jvp``, ``linearize``, ``vjp`` and ``vmap``.  Each collective
here is an ``autograd.Function`` of one form:

- the forward is local (:func:`copy_to_axis`) or one blocking op
  registered with ``torch.library`` (:func:`_all_reduce_op`,
  :func:`_all_gather_op`), which ``linearize``'s trace records and replays
  whole.  An in-place ``dist.all_reduce`` traced into the forward replays
  racily (a replay may read the rank's own term
  before the others arrive).  The functional ``_c10d_functional`` op with
  its separate ``wait_tensor`` replays right for a forward, but not for a
  gradient linearized through its backward (a Hessian-vector product):
  ``linearize`` folds the primal collectives into constants and keeps the
  asynchronous result apart from its wait, and the product came out
  wrong;
- ``setup_context`` is separate from the forward, as ``torch.func`` needs;
- ``jvp`` applies the same collective to the tangent (each is linear) and
  ``backward`` applies the adjoint, both through the ``Function``s
  themselves, so that derivatives of derivatives see them;
- a ``vmap`` rule applies the collective to the batched tensor whole.

Two semantics sit side by side:

- **the joined program** (:func:`all_reduce_sum`, :func:`all_gather`,
  :func:`split`, :func:`ppermute`): every rank's output is a value of its
  own, and rank ``r``'s autograd computes the derivative of every rank's
  outputs, weighted by every rank's cotangent, with respect to rank
  ``r``'s inputs.  So the adjoint of :func:`all_reduce_sum` is
  :func:`all_reduce_sum`, that of :func:`all_gather` is a reduce-scatter
  (:func:`split` of :func:`all_reduce_sum`) and that of :func:`ppermute` is
  the inverse shift.  :func:`split` (keep this rank's block) is local: its
  adjoint puts the block back among zeros, which autograd derives.  The
  pair is adjoint across the sharded and replicated inner products: for
  ``x`` sharded and ``y`` replicated, ``<all_gather(x), y>`` equals the sum
  over the ranks of ``<x, split(y)>``;
- **one replicated program** (:func:`copy_to_axis`, :func:`reduce_from_axis`,
  :func:`gather_from_axis`, Megatron's f, g and gather): the value is one,
  held alike on every rank, as ``shard_map``'s replicated inputs and
  outputs are, and every rank's autograd computes its one derivative.
  :func:`copy_to_axis` is the identity forward and sums the ranks'
  cotangents backward: a replicated input of which each rank uses a part
  (its stage's layers) gets the whole gradient on every rank.
  :func:`reduce_from_axis` sums the ranks' partial values forward and
  passes the replicated cotangent through backward.  Each is the other's
  adjoint.  :func:`gather_from_axis` joins the ranks' blocks into one
  replicated value forward and keeps the rank's block of the replicated
  cotangent backward (a local op); its adjoint keeps a block forward and
  gathers backward.  :func:`all_reduce_sum` in place of
  :func:`reduce_from_axis` would make every rank's autograd add every
  rank's cotangent of the replicated loss: the gradient would come out as
  many times too large as the axis has ranks; :func:`all_gather` in place
  of :func:`gather_from_axis` would add every rank's alike cotangent in
  its reduce-scatter, as many times too large again.

gloo takes ``all_reduce``, ``broadcast`` and ``all_to_all_single`` on
CUDA tensors (the last checked on torch 2.11 with an H100) but no
all-gather, so on gloo :func:`all_gather` is an ``all_reduce`` of a
zero-filled buffer into which each rank writes its block.  Adding zeros
is exact, except that a ``-0.0`` block comes back as ``+0.0``.
:func:`ppermute` is one ``all_to_all_single`` on every backend, in which
each rank sends its block to one rank and receives one block: a shift
hands the collective one rank's block, not the axis's.  On an axis of
one rank every collective is the identity and calls nothing.

A model reads the axes a step runs under through :func:`batch_axis`,
:func:`sequence_axis`, :func:`expert_axis`, :func:`tensor_axis` and
:func:`tensor_role`, and reads every leaf it splits through
:func:`leaf_block`; the steps set the axes with :func:`axes`.  No
collective is wrapped in a ``try``: a rank that fails leaves the others to
the group's timeout.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it: the process group of the
    ranks along it, their count and this rank's position among them."""

    group: object
    size: int
    rank: int


def mesh_axis(mesh, name: str) -> Axis:
    """The :class:`Axis` of ``mesh``'s axis ``name``."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        raise ValueError(f"mesh has no {name!r} axis (axes {names})")
    return Axis(mesh.get_group(name), mesh.size(names.index(name)),
                mesh.get_local_rank(name))


@torch.library.custom_op("pytorchhessianfree_tpu_torch::all_reduce_sum",
                         mutates_args=())
def _all_reduce_op(x: torch.Tensor, group_name: str) -> torch.Tensor:
    """A blocking all-reduce into a new tensor, one opaque op to a trace."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=_resolve_group(group_name))
    return out


@_all_reduce_op.register_fake
def _(x, group_name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _resolve_group(name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name)


def _reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _all_reduce_op(x, axis.group.group_name)


def _gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` joined along ``dim`` (no autograd)."""
    if dist.get_backend(axis.group) == "gloo":
        k = x.shape[dim]
        shape = list(x.shape)
        pieces = []
        for count in (axis.rank * k, (axis.size - 1 - axis.rank) * k):
            shape[dim] = count
            pieces.append(x.new_zeros(shape))
        return _reduce(torch.cat([pieces[0], x, pieces[1]], dim), axis)
    return _all_gather_op(x.movedim(dim, 0).contiguous(), axis.size,
                          axis.group.group_name).movedim(0, dim)


def all_to_all(chunks, counts, axis: Axis):
    """A blocking all-to-all over ``axis`` (no autograd): ``chunks[r]``, a
    1-D tensor, goes to rank ``r``; the 1-D chunk of ``counts[r]`` entries
    that rank ``r`` sends here comes back at index ``r``.  This rank's own
    chunk does not travel.  One ``all_to_all_single``, which gloo takes on
    CUDA tensors too (module docstring)."""
    me = axis.rank
    sent = [0 if r == me else c.numel() for r, c in enumerate(chunks)]
    got = [0 if r == me else counts[r] for r in range(axis.size)]
    send = torch.cat([c for r, c in enumerate(chunks) if r != me])
    recv = send.new_empty(sum(got))
    dist.all_to_all_single(recv, send, got, sent, group=axis.group)
    out = list(torch.split(recv, got))
    out[me] = chunks[me]
    return out


@torch.library.custom_op("pytorchhessianfree_tpu_torch::all_gather",
                         mutates_args=())
def _all_gather_op(x: torch.Tensor, size: int, group_name: str
                   ) -> torch.Tensor:
    """A blocking all-gather along dimension 0 into a new tensor."""
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=_resolve_group(group_name))
    return out


@_all_gather_op.register_fake
def _(x, size, group_name):
    return x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))


def _block(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    size = x.shape[dim]
    if size % axis.size:
        raise ValueError(
            f"split: dimension {dim} of size {size} does not divide over "
            f"{axis.size} ranks"
        )
    k = size // axis.size
    return x.narrow(dim, axis.rank * k, k)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _AllReduceSum.apply(t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _AllReduceSum.apply(x, axis), in_dims[0]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: every rank's cotangent of this rank's block
        summed = _AllReduceSum.apply(g, ctx.axis)
        return split(summed, ctx.axis, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _axis, _dim):
        return _AllGather.apply(t, ctx.axis, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        if in_dims[0] is None:
            return _AllGather.apply(x, axis, dim), None
        return _AllGather.apply(x.movedim(in_dims[0], 0), axis, dim + 1), 0


@torch.library.custom_op("pytorchhessianfree_tpu_torch::ppermute",
                         mutates_args=())
def _ppermute_op(x: torch.Tensor, shift: int, size: int, rank: int,
                 group_name: str) -> torch.Tensor:
    """A blocking shift into a new tensor, one opaque op to a trace: one
    ``all_to_all_single`` in which this rank sends ``x`` to rank ``(rank +
    shift) mod size`` alone and receives only from rank ``(rank - shift)
    mod size``; every other split is empty."""
    n = x.numel()
    sent, got = [0] * size, [0] * size
    sent[(rank + shift) % size] = n
    got[(rank - shift) % size] = n
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out.view(-1), x.contiguous().view(-1), got, sent,
                           group=_resolve_group(group_name))
    return out


@_ppermute_op.register_fake
def _(x, shift, size, rank, group_name):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _shift(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """The ``x`` of rank ``(rank - shift) mod size`` (no autograd)."""
    return _ppermute_op(x, shift, axis.size, axis.rank,
                        axis.group.group_name)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, shift):
        return _shift(x, axis, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.shift = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # the inverse shift: each rank's cotangent goes back to its source
        return _Ppermute.apply(g, ctx.axis, -ctx.shift), None, None

    @staticmethod
    def jvp(ctx, t, _axis, _shift):
        return _Ppermute.apply(t, ctx.axis, ctx.shift)

    @staticmethod
    def vmap(info, in_dims, x, axis, shift):
        return _Ppermute.apply(x, axis, shift), in_dims[0]


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(x, axis, dim):
        return _gather(x, axis, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        # the replicated cotangent: every rank keeps its own block
        return _SplitToAxis.apply(g, ctx.axis, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _axis, _dim):
        return _GatherFromAxis.apply(t, ctx.axis, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        if in_dims[0] is None:
            return _GatherFromAxis.apply(x, axis, dim), None
        return _GatherFromAxis.apply(x.movedim(in_dims[0], 0), axis,
                                     dim + 1), 0


class _SplitToAxis(torch.autograd.Function):
    """This rank's block of a replicated value, whose adjoint gathers the
    blocks' cotangents (:func:`gather_from_axis`'s adjoint)."""

    @staticmethod
    def forward(x, axis, dim):
        return _block(x, axis, dim).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _GatherFromAxis.apply(g, ctx.axis, ctx.dim), None, None

    @staticmethod
    def jvp(ctx, t, _axis, _dim):
        return _SplitToAxis.apply(t, ctx.axis, ctx.dim)

    @staticmethod
    def vmap(info, in_dims, x, axis, dim):
        if in_dims[0] is None:
            return _SplitToAxis.apply(x, axis, dim), None
        return _SplitToAxis.apply(x.movedim(in_dims[0], 0), axis,
                                  dim + 1), 0


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _ReduceFromAxis.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _CopyToAxis.apply(t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _CopyToAxis.apply(x, axis), in_dims[0]


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(x, axis):
        return _reduce(x, axis)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.axis = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _CopyToAxis.apply(g, ctx.axis), None

    @staticmethod
    def jvp(ctx, t, _):
        return _ReduceFromAxis.apply(t, ctx.axis)

    @staticmethod
    def vmap(info, in_dims, x, axis):
        return _ReduceFromAxis.apply(x, axis), in_dims[0]


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis``, on every rank."""
    if axis is None or axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int = 0):
    """The ranks' blocks of ``x`` joined along ``dim`` in rank order, on
    every rank."""
    if axis is None or axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.dim())


def split(x: torch.Tensor, axis: Optional[Axis], dim: int = 0):
    """This rank's block of ``x`` along ``dim`` (equal contiguous blocks in
    rank order); a local op, the adjoint of :func:`all_gather`."""
    if axis is None or axis.size == 1:
        return x
    return _block(x, axis, dim % x.dim())


def ppermute(x: torch.Tensor, axis: Optional[Axis], shift: int = 1):
    """Each rank's ``x`` sent ``shift`` ranks on along ``axis``, cyclically:
    rank ``r`` returns the ``x`` of rank ``(r - shift) mod size``, as
    ``lax.ppermute`` with the permutation ``[(i, (i + shift) % size)]``.
    Joined semantics; the adjoint is the inverse shift."""
    if axis is None or shift % axis.size == 0:
        return x
    return _Ppermute.apply(x, axis, shift % axis.size)


def copy_to_axis(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """A replicated ``x`` entering work split over ``axis``: the identity,
    whose backward sums the ranks' cotangents over the axis (Megatron's
    f; module docstring).  The adjoint of :func:`reduce_from_axis`."""
    if axis is None or axis.size == 1:
        return x
    return _CopyToAxis.apply(x, axis)


def reduce_from_axis(x: torch.Tensor, axis: Optional[Axis]):
    """The ranks' partial values summed over ``axis`` into one replicated
    value, whose backward passes the replicated cotangent through
    (Megatron's g; module docstring).  The adjoint of
    :func:`copy_to_axis`."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFromAxis.apply(x, axis)


def gather_from_axis(x: torch.Tensor, axis: Optional[Axis], dim: int = -1):
    """The ranks' blocks of ``x`` joined along ``dim`` in rank order into
    one replicated value, whose backward keeps this rank's block of the
    replicated cotangent (Megatron's gather; module docstring)."""
    if axis is None or axis.size == 1:
        return x
    return _GatherFromAxis.apply(x, axis, dim % x.dim())


# -- the axes a step runs under ------------------------------------------


class _Axes(NamedTuple):
    batch: Optional[Axis] = None
    sequence: Optional[Axis] = None
    expert: Optional[Axis] = None
    tensor: Optional[Axis] = None
    batch_reduction: str = "mean"
    tensor_leaves: frozenset = frozenset()
    block_shapes: Optional[dict] = None


_axes = _Axes()


@contextlib.contextmanager
def axes(batch: Optional[Axis] = None, sequence: Optional[Axis] = None,
         expert: Optional[Axis] = None, tensor: Optional[Axis] = None,
         batch_reduction: str = "mean", tensor_leaves=(),
         block_shapes=None):
    """Run the body with these axes visible to the model's forward:

    - ``batch``: the batch's rows are split over it, batch statistics
      (:func:`batch_mean`) are taken over every rank's rows and a MoE
      layer routes every rank's rows (:mod:`~..models.moe`); the ranks'
      losses are averaged over it, or summed when ``batch_reduction`` is
      ``"sum"`` (:func:`batch_share`);
    - ``sequence``: the sequence axis of a decoder's tokens is split over
      it (context parallelism, :mod:`~..models.transformer`);
    - ``expert``: a MoE layer's experts are split over it (expert
      parallelism, :mod:`~..models.moe`);
    - ``tensor``: a transformer block's heads and feed-forward columns are
      split over it, one replicated program whose sub-layers each end in a
      :func:`reduce_from_axis` (Megatron tensor parallelism,
      :mod:`~..models.transformer`), and an MLP layer's output columns,
      gathered by :func:`gather_from_axis` (:mod:`~..models.mlp`):
      ``tensor_leaves`` names the roles split over it
      (:func:`tensor_role`);
    - ``block_shapes``: per role, the shapes of the blocks that the leaves
      split over the tensor or the expert axis are passed as
      (:func:`leaf_block`)."""
    global _axes
    saved, _axes = _axes, _Axes(batch, sequence, expert, tensor,
                                batch_reduction, frozenset(tensor_leaves),
                                block_shapes or {})
    try:
        yield
    finally:
        _axes = saved


@contextlib.contextmanager
def local_batch():
    """Suspend the batch axis: per-sample gradients see each sample alone,
    as they do in the JAX package, where a ``vmap`` over samples gives each
    a batch of one."""
    global _axes
    saved, _axes = _axes, _axes._replace(batch=None)
    try:
        yield
    finally:
        _axes = saved


def batch_axis() -> Optional[Axis]:
    return _axes.batch


def sequence_axis() -> Optional[Axis]:
    return _axes.sequence


def expert_axis() -> Optional[Axis]:
    return _axes.expert


def tensor_axis() -> Optional[Axis]:
    return _axes.tensor


_SUBLAYERS = ("attention", "mlp")


def tensor_role(role: str, count: int) -> Optional[Axis]:
    """The tensor axis when the forward splits ``role`` over it, else
    ``None``: every rank computes the role whole.  The roles are a block's
    ``"attention"`` (``count`` heads) and ``"mlp"`` (``count`` columns),
    the leaves outside the blocks (``"embed"``, ``"pos"``, ``"head"``;
    ``count`` features or classes) and an MLP's layers (``"layers.{i}"``;
    ``count`` output columns).  While the plan records a forward on
    whole leaves (:func:`recording`), a block's role, or a leaf's named in
    :func:`axes`' ``tensor_leaves``, splits when the axis divides its
    ``count``.  In a step the leaves are blocks, whose widths no longer
    tell, and ``tensor_leaves`` names exactly the roles that the
    recording split."""
    tp = _axes.tensor
    if tp is None or tp.size == 1:
        return None
    if _recording is None:
        return tp if role in _axes.tensor_leaves else None
    named = role in _SUBLAYERS or role in _axes.tensor_leaves
    split = named and count % tp.size == 0
    _recording.roles.setdefault(role, set()).add(split)
    return tp if split else None


def leaf_block(leaf: torch.Tensor, axis: Axis, role: str, dim: int,
               parts: int = 1) -> torch.Tensor:
    """This rank's block of a parameter leaf that the forward splits over
    ``axis`` along ``dim``: the leaf's ``parts`` equal groups along ``dim``
    (the fused ``qkv``'s Q, K and V) each cut in ``axis.size`` blocks, and
    the rank's block of each joined in order.  Every narrowing of a split
    leaf goes through here, so that the plan learns each leaf's block from
    the model: while it records a forward on whole leaves
    (:func:`recording`), the leaf is narrowed and its block logged.  In a
    step ``leaf`` is this block already and comes back unchanged; its
    shape must be one that :func:`axes`' ``block_shapes`` lists for
    ``role``, so that a whole leaf passed by mistake raises."""
    if _recording is None:
        shapes = (_axes.block_shapes or {}).get(role, ())
        if tuple(leaf.shape) not in shapes:
            raise ValueError(
                f"{role}: expected this rank's block, of shape one of "
                f"{sorted(shapes)}; got {tuple(leaf.shape)}")
        return leaf
    group = leaf.shape[dim] // parts
    k = group // axis.size
    starts = tuple(g * group + axis.rank * k for g in range(parts))
    _recording.log(leaf, role, dim, starts, k)
    pieces = [leaf.narrow(dim, s, k) for s in starts]
    return pieces[0] if parts == 1 else torch.cat(pieces, dim)


class _Recording:
    """What :func:`leaf_block` and :func:`tensor_role` saw in a forward on
    whole leaves: per leaf (its index among ``leaves``) the block
    ``(dim, starts, length)`` it was read at, and per role whether it was
    split."""

    def __init__(self, leaves):
        self.index = {id(t): i for i, t in enumerate(leaves)}
        self.blocks, self.roles, self.leaf_roles = {}, {}, {}

    def log(self, leaf, role, dim, starts, length):
        i = self.index.get(id(leaf))
        if i is None:
            raise ValueError(
                f"{role}: leaf_block was given a tensor that is not a "
                "parameter leaf (a copy or a view of one)")
        block = (dim, starts, length)
        if self.blocks.setdefault(i, block) != block:
            raise ValueError(
                f"{role}: leaf {i} read at {self.blocks[i]} and at {block}")
        self.leaf_roles[i] = role


_recording: Optional[_Recording] = None


@contextlib.contextmanager
def recording(leaves):
    """Record the blocks that a forward on the parameter ``leaves`` reads
    (:class:`_Recording`, yielded)."""
    global _recording
    saved, _recording = _recording, _Recording(leaves)
    try:
        yield _recording
    finally:
        _recording = saved


def batch_share(x: torch.Tensor) -> torch.Tensor:
    """A value of the whole batch (a MoE LM's aux) as this rank's share of
    its loss: divided by the batch axis's size when the ranks' losses are
    summed over it, so that it counts once; as it is when they are
    averaged."""
    axis = _axes.batch
    if axis is None or axis.size == 1 or _axes.batch_reduction != "sum":
        return x
    return x / axis.size


def batch_mean(x: torch.Tensor, dims) -> torch.Tensor:
    """``torch.mean(x, dims, keepdim=True)`` over every rank's rows of the
    batch axis (equal shares): each rank's sum, all-reduced, over the
    global count."""
    axis = _axes.batch
    if axis is None or axis.size == 1:
        return torch.mean(x, dim=dims, keepdim=True)
    count = axis.size
    for d in dims:
        count *= x.shape[d]
    return all_reduce_sum(torch.sum(x, dim=dims, keepdim=True), axis) / count
