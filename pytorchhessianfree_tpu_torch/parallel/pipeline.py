"""Pipeline parallelism: a GPipe-style microbatch schedule over a mesh axis
(port of :mod:`pytorchhessianfree_tpu.parallel.pipeline`).

The layer axis of a stacked-block model
(:func:`~..models.transformer.stack_blocks`) splits over a ``stage`` mesh
axis of ranks, each stage holding ``L / S`` consecutive layers, and
microbatches flow from stage to stage through
:func:`~.collectives.ppermute`.  The same pipelined callable
serves the gradient, the GGN's and the Hessian's matvecs (``jvp``,
``linearize``, ``vjp``, forward over reverse) and the batched selection's
``vmap``, so ``hf_step``, ``make_hf_step`` and ``HessianFree`` run it
unchanged on every rank: the optimizer does not know the model is
pipelined.

The JAX package runs the schedule under ``shard_map`` with the blocks as
``P(stage)`` and ``x`` and the result replicated.  The port states that
boundary with the replicated-program pair of :mod:`.collectives`:

- the stacked blocks and ``x`` enter through
  :func:`~.collectives.copy_to_axis` (the identity; its backward sums the
  ranks' cotangents), and each stage takes its own layers locally;
- the last stage's outputs leave through
  :func:`~.collectives.reduce_from_axis` (a sum with the other stages'
  zeros; its backward passes the cotangent through).

So each rank's autograd computes the one loss's whole gradient and matvecs,
alike on every rank, and the step applies no reduction over the stage axis.

The schedule is a Python loop of ``M + S - 1`` ticks that every rank runs
in the same order, with the same collectives, computing on every tick as
the JAX package does (a bubble tick's result is masked, not skipped): the
derivative passes of every rank then call the same collectives in the same
order.  A tick moves one microbatch: each stage sends its microbatch to
the next stage alone, in one ``all_to_all_single`` whose other splits are
empty (:func:`~.collectives.ppermute`), as ``lax.ppermute`` does.

Cost model: a fill and drain of ``M + S - 1`` ticks serves ``M``
microbatches, so the bubble is ``(S - 1) / (M + S - 1)`` of every forward,
backward and curvature pass.  Each tick of each pass hands the collective
one microbatch per rank (its tangent's or cotangent's in the derivative
passes), whatever ``S``.  Every rank holds every stage's weights here
(they are replicated parameters of the step); keeping only a stage's own
layers and skipping the bubble ticks' work are performance work
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..utils.flatten import tree_flatten, tree_map
from . import collectives


def pipeline_blocks(
    stacked_blocks: Any,
    x: torch.Tensor,
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    stage_axis: str = "stage",
    n_microbatches: int = 4,
) -> torch.Tensor:
    """Run ``L`` stacked layers over ``x`` as an ``S``-stage pipeline.

    ``stacked_blocks``: a tree whose leaves carry a leading layer axis
    ``[L, ...]`` (:func:`~..models.transformer.stack_blocks`), replicated
    on every rank; ``L`` must divide by the stage-axis size ``S`` -- stage
    ``s`` runs layers ``[s L / S, (s + 1) L / S)``.  ``x``: ``[N, ...]``
    activations, replicated; ``N`` must divide by ``n_microbatches``
    (microbatching is over the batch axis, exact for per-sample models).
    ``block_fn(blk, h) -> h`` is one layer (close over statics like the
    head count; wrap it in :func:`~..utils.remat.checkpoint` for per-layer
    remat).  ``mesh`` is a
    :class:`~torch.distributed.device_mesh.DeviceMesh` with an axis named
    ``stage_axis``; every rank along it makes the same call.

    The values are those of running the layers in sequence -- the schedule
    only reorders where each layer runs.  Returns ``[N, ...]``, replicated
    over the stage axis.
    """
    axis = collectives.mesh_axis(mesh, stage_axis)
    S = axis.size
    L = tree_flatten(stacked_blocks)[0][0].shape[0]
    if L % S != 0:
        raise ValueError(f"{L} layers do not divide over {S} pipeline stages")
    N = x.shape[0]
    M = n_microbatches
    if N % M != 0:
        raise ValueError(f"batch {N} does not divide into {M} microbatches")
    local = tree_map(
        lambda b: collectives.split(collectives.copy_to_axis(b, axis),
                                    axis, 0),
        stacked_blocks)
    layers = [tree_map(lambda b, i=i: b[i], local) for i in range(L // S)]
    xm = collectives.copy_to_axis(x, axis).reshape(M, N // M, *x.shape[1:])
    # 0-d masks on the activations' device: every rank runs the same ops,
    # whose derivatives then call the same collectives on every rank
    first = torch.tensor(axis.rank == 0, device=x.device)
    last = torch.tensor(axis.rank == S - 1, device=x.device)

    buf = torch.zeros_like(xm[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 takes microbatch t; later stages take what the previous
        # stage sent last tick (the skewed GPipe schedule)
        h = torch.where(first, xm[min(t, M - 1)], buf)
        for blk in layers:
            h = block_fn(blk, h)
        buf = collectives.ppermute(h, axis)
        if t >= S - 1:  # microbatch t - (S - 1) leaves the last stage
            outs.append(h)
    out = torch.stack(outs)
    out = collectives.reduce_from_axis(
        torch.where(last, out, torch.zeros_like(out)), axis)
    return out.reshape(N, *x.shape[1:])
