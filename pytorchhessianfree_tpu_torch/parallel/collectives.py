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
  Megatron's f and g): the value is one, held alike on every rank, as
  ``shard_map``'s replicated inputs and outputs are, and every rank's
  autograd computes its one derivative.  :func:`copy_to_axis` is the
  identity forward and sums the ranks' cotangents backward: a replicated
  input of which each rank uses a part (its stage's layers) gets the whole
  gradient on every rank.  :func:`reduce_from_axis` sums the ranks' partial
  values forward and passes the replicated cotangent through backward.
  Each is the other's adjoint.  :func:`all_reduce_sum` in place of
  :func:`reduce_from_axis` would make every rank's autograd add every
  rank's cotangent of the replicated loss: the gradient would come out as
  many times too large as the axis has ranks.

gloo takes only ``all_reduce`` and ``broadcast`` on CUDA tensors, so on
gloo :func:`all_gather` (and so :func:`ppermute`) is an ``all_reduce`` of a
zero-filled buffer into which each rank writes its block.  Adding zeros is
exact, except that a ``-0.0`` block comes back as ``+0.0``.  On an axis of
one rank every collective is the identity and calls nothing.

A model reads the axes a step runs under through :func:`batch_axis`,
:func:`sequence_axis`, :func:`expert_axis` and :func:`tensor_axis`; the
steps set them with :func:`axes`.  No collective is wrapped in a
``try``: a rank that fails leaves the others to the group's timeout.
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


def _shift(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    """The block of rank ``(rank - shift) mod size`` (no autograd): every
    rank's ``x`` gathered along a new leading dimension."""
    whole = _gather(x.unsqueeze(0).contiguous(), axis, 0)
    return whole[(axis.rank - shift) % axis.size]


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
    if axis is None or axis.size == 1:
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


# -- the axes a step runs under ------------------------------------------


class _Axes(NamedTuple):
    batch: Optional[Axis] = None
    sequence: Optional[Axis] = None
    expert: Optional[Axis] = None
    tensor: Optional[Axis] = None


_axes = _Axes()


@contextlib.contextmanager
def axes(batch: Optional[Axis] = None, sequence: Optional[Axis] = None,
         expert: Optional[Axis] = None, tensor: Optional[Axis] = None):
    """Run the body with these axes visible to the model's forward:

    - ``batch``: the batch's rows are split over it, and batch statistics
      (:func:`batch_mean`) are taken over every rank's rows;
    - ``sequence``: the sequence axis of a decoder's tokens is split over
      it (context parallelism, :mod:`~..models.transformer`);
    - ``expert``: a MoE layer's experts are split over it (expert
      parallelism, :mod:`~..models.moe`);
    - ``tensor``: a transformer block's heads and feed-forward columns are
      split over it, one replicated program whose sub-layers each end in a
      :func:`reduce_from_axis` (Megatron tensor parallelism,
      :mod:`~..models.transformer`)."""
    global _axes
    saved, _axes = _axes, _Axes(batch, sequence, expert, tensor)
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
