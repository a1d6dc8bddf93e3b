"""Device meshes over the ranks of a process group (port of
:mod:`pytorchhessianfree_tpu.parallel.mesh`).

The JAX package's mesh is a grid of devices with named axes; the port's is
a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group (one process per device), with the same axis names.
Loss, gradient and curvature-matvec accumulation are linear, so a ``data``
axis that splits the batch, plus one ``all_reduce`` per evaluation, gives
the reference's accumulated sums in parallel (:mod:`.data_parallel`).

Batches stay plain tensors: ``torch.func``'s ``linearize``, ``jvp`` and
``vmap`` over DTensor are nothing the optimizer can rely on.  So
:func:`shard_batch` returns this rank's rows of the global batch, and
:func:`batch_sharding` / :func:`replicated` return a :class:`Sharding`,
the port's form of a ``NamedSharding``: the mesh, the axis and the split
dimension, which :func:`shard_batch` and
:class:`~..runtime.prefetch.DevicePrefetcher` read.

Beyond the batch, a :class:`PartitionSpec` places one tensor on the mesh
with the JAX package's field semantics, one entry per leading dimension:
``None`` (not split), an axis name, or a tuple of names (split over their
product, the first name outermost); an :class:`ExpertSpec` also marks the
experts of a MoE layer.  :func:`shard_leaf` cuts this rank's
block of a tensor and :func:`unshard_leaf` joins the ranks' blocks again;
:func:`model_axis` gives the group and rank along the solver's model axis
(:mod:`.sharded`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..utils.flatten import tree_map
from . import collectives, distributed


def balanced_mesh_shape(n: int, k: int) -> tuple:
    """Factor ``n`` devices into ``k`` mesh axes as evenly as possible.

    Greedy: each axis takes the divisor of the remaining count closest to the
    k-th root (e.g. 8 devices x 2 axes -> (2, 4); 12 x 2 -> (3, 4); a prime
    count falls back to (n, 1, ..., 1)).  The product is always exactly ``n``.
    """
    if k < 1 or n < 1:
        raise ValueError(f"Invalid mesh factorization: {n} devices, {k} axes")
    shape = []
    for axes_left in range(k, 1, -1):
        target = n ** (1.0 / axes_left)
        best = min(
            (d for d in range(1, n + 1) if n % d == 0),
            key=lambda d: abs(d - target),
        )
        shape.append(best)
        n //= best
    shape.append(n)
    return tuple(shape)


def make_mesh(
    num_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
    shape: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A 1-D (or reshaped n-D) mesh over the group's ranks.

    ``devices`` are ranks of the default group (all of them by default).
    Multi-axis meshes factor the count with :func:`balanced_mesh_shape`
    unless ``shape`` is given.  In a process that joined no group, a 1-rank
    group is formed first (in memory, on the device that
    :func:`~.distributed.initialize_distributed` recorded, the card by
    default), so the mesh has one rank.  Every rank of the group must make
    the same call: building a mesh is a collective.
    """
    if not dist.is_initialized():
        distributed._init_single_process_group()
    if devices is None:
        devices = list(range(dist.get_world_size()))
    devices = [int(r) for r in devices]
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(
                f"make_mesh(num_devices={num_devices}) but only "
                f"{len(devices)} rank(s) are in the group -- a silently "
                "smaller mesh would make every sharding a no-op (start "
                "more processes, e.g. torch.distributed.run "
                "--nproc-per-node N)."
            )
        devices = devices[:num_devices]
    arr = np.asarray(devices)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(
                f"shape {shape} has {len(shape)} axes, expected "
                f"{len(axis_names)} ({axis_names})"
            )
        if int(np.prod(shape)) != len(devices):
            raise ValueError(
                f"shape {shape} does not cover {len(devices)} devices"
            )
        arr = arr.reshape(shape)
    elif len(axis_names) > 1:
        arr = arr.reshape(balanced_mesh_shape(len(devices), len(axis_names)))
    return DeviceMesh(
        distributed.rank_device().type, torch.from_numpy(arr),
        mesh_dim_names=tuple(axis_names),
    )


class Sharding(NamedTuple):
    """Where the rows of a batch live: the port's form of a
    ``NamedSharding``.  ``axis`` is the mesh axis that splits dimension
    ``dim`` of every leaf into equal contiguous shares, one per rank along
    it (:func:`~.distributed.global_batch_slice`); ``axis=None`` replicates
    the batch on every rank."""

    mesh: DeviceMesh
    axis: Optional[str]
    dim: int = 0

    def rows(self, size: int) -> slice:
        """This rank's share of ``size`` rows."""
        if self.axis is None:
            return slice(0, size)
        return distributed.global_batch_slice(
            size, self.mesh.size(self.mesh.mesh_dim_names.index(self.axis)),
            self.mesh.get_local_rank(self.axis),
        )

    def take(self, leaf):
        """This rank's rows of one array or tensor (other leaves pass)."""
        if not hasattr(leaf, "shape") or self.axis is None:
            return leaf
        index = (slice(None),) * self.dim + (self.rows(leaf.shape[self.dim]),)
        return leaf[index]


def batch_sharding(mesh: DeviceMesh, axis_name: str = "data") -> Sharding:
    """Split the leading (batch) dimension over the mesh axis."""
    return Sharding(mesh, axis_name)


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: DeviceMesh, axis_name: str = "data"):
    """This rank's rows of a global batch tree, as plain tensors on the
    rank's device; the rows are cut before the copy, so each rank moves only
    its own."""
    sharding = batch_sharding(mesh, axis_name)
    device = distributed.rank_device()
    return tree_map(
        lambda a: torch.as_tensor(sharding.take(a)).contiguous().to(device),
        batch,
    )


class PartitionSpec(tuple):
    """Per-dimension placement of a tensor on a mesh, as the JAX package's
    ``jax.sharding.PartitionSpec``: ``PartitionSpec(None, "model")`` splits
    dimension 1 over the ``model`` axis; ``PartitionSpec()`` replicates;
    dimensions past the last entry are not split."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"{type(self).__name__}{tuple.__repr__(self)}"


class ExpertSpec(PartitionSpec):
    """A :class:`PartitionSpec` whose first entry splits the experts of a
    mixture-of-experts layer (:func:`~..models.moe.moe_param_specs`).  It
    places a tensor as a ``PartitionSpec`` does; the mark tells the sharded
    steps to run each rank's experts only (expert parallelism,
    :mod:`.sharded`), where a plain spec's blocks would be gathered."""


def _names(part) -> tuple:
    return (part,) if isinstance(part, str) else tuple(part)


def _blocks(mesh: DeviceMesh, dim_size: int, names: tuple, dim: int):
    """(block length, this rank's block index) of a dimension split over
    the product of ``names``."""
    count, index = 1, 0
    for name in names:
        axis = collectives.mesh_axis(mesh, name)
        count, index = count * axis.size, index * axis.size + axis.rank
    if dim_size % count:
        raise ValueError(
            f"dimension {dim} of size {dim_size} does not divide over the "
            f"{count} ranks of axes {names}"
        )
    return dim_size // count, index


def shard_leaf(t: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a :class:`PartitionSpec`
    or ``None`` for replicated), in memory of its own."""
    for dim, part in enumerate(spec or ()):
        if part is None:
            continue
        k, index = _blocks(mesh, t.shape[dim], _names(part), dim)
        t = t.narrow(dim, index * k, k)
    return t.clone(memory_format=torch.contiguous_format)


def unshard_leaf(t: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``, on every
    rank: the inverse of :func:`shard_leaf` (a collective over the axes
    that ``spec`` names)."""
    for dim, part in enumerate(spec or ()):
        if part is None:
            continue
        # innermost name first: its ranks hold adjacent blocks
        for name in reversed(_names(part)):
            axis = collectives.mesh_axis(mesh, name)
            if axis.size > 1:
                t = collectives._gather(t, axis, dim)
    return t


def model_axis(mesh: DeviceMesh, name: str = "model") -> collectives.Axis:
    """The group of the ranks along the mesh's model axis, their count and
    this rank's index among them."""
    return collectives.mesh_axis(mesh, name)
