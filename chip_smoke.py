#!/usr/bin/env python3
"""Drive the PyTorch port (``pytorchhessianfree_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no ``ok`` line:

1. the device: its name, and name and power limit from ``nvidia-smi``;
2. the kernel build from ``pytorchhessianfree_tpu_torch/csrc``;
3. the kernel build's ``-Xptxas -v`` report (registers, spills), the CUDA
   ``fused_cg_update`` against its plain PyTorch version on the card (f32
   and f64, at the n of phases 6 and 8 and at a ragged n), bitwise
   reproducibility of its reductions, and three times of each version at
   every timed n: the device time of a call with L2 flushed before it (the
   durations of its kernels in a ``torch.profiler`` trace; one kernel per
   call for K1), the host time of a call (the best of 7 rounds of 200
   calls queued with no synchronise) and the per-call CUDA-event time.
   The flush keeps the inputs out of L2, but outputs that fit in it (8 n
   bytes up to ~6M) can be written back after the kernel ends, so the
   share of the 28 n-byte bound can read a little above 100% there;
4. CG on the card (kernel) against CG on the CPU (plain version) in f64;
5. a narrow ResNet-18 HF step on the card against the same step on the CPU
   in f64;
6. the main path: 1 Hessian-free step of the full-width ResNet-18 (MNIST
   shapes, batch 32, GGN, ``HFConfig(damping=1.0, cg_max_iter=50)``) in f32,
   with the kernel's launch count checked against the CG iterations, and
   the GGN matvec time;
7. two narrow All-CNN-C ``acc_step``s preconditioned with the empirical-
   Fisher diagonal on the card against the same steps on the CPU in f64;
8. the accumulated path: 2 ``acc_step``s of the full-width All-CNN-C on
   CIFAR-100 shapes (batch 256 as 4 chunks of 64, curvature on 2 of them,
   cross-entropy plus L2, GGN, ``HFConfig(damping=1.0, cg_max_iter=50)``)
   in f32, each preconditioned with an EMA of ``get_preconditioner``'s
   diagonal, after the reduction self-test; with the kernel's launch count
   checked against the CG iterations, and the times of a step, of the
   diagonal and of one accumulated matvec;
9. the narrow decoder LM and MoE LM (d_model 32, 2 layers, vocab 32, T 16):
   1 HF step each on the card against the same step on the CPU in f64,
   and the narrow encoder classifier's forward on both;
10. the full-width decoder LM (19,505,152 parameters, batch 32 x T 128 of
    the affine next-token rule on vocab 1024, GGN,
    ``HFConfig(damping=1.0, cg_max_iter=50)``, f32): 1 step, the build,
    matvec and peak memory, a bf16-curvature step from the same start with
    its matvec held against f32, and a T 1024 point whose chunked matvecs
    (linearized; one-shot; one-shot and rematerialized) are held against
    full attention, with the peak memory of each;
11. the full-width MoE decoder LM (8 experts, top-2, capacity 1.25, one
    router group; 107,717,632 parameters): 1 step, matvec and peak memory;
12. the rest of the optimizer on the main path (ResNet-18/MNIST b32 as in
    phase 6, ``cudnn.deterministic`` on): a) a rank-32 Nystrom sketch of the
    GGN (eigenvalues >= 0 and descending, orthonormal columns, the sketch
    below the operator along its top direction; build time and peak
    memory); e) the Ritz values of a 32-step Lanczos run and a 4-probe SLQ
    whose trace must equal ``dim * mean_p(v_p^T A v_p)``; b) the next
    step's damped system solved by CG plain, with the iterates stored in
    bf16 (the same iteration bit for bit, a bf16 buffer) and with the
    Nystrom preconditioner; c) a Nystrom-preconditioned step with
    ``rich_stats`` (a finite m-history, ``format_rich_stats``); d) a
    sequential and a batched selection step from one saved state (the same
    CG iterations, shared losses within rtol 1e-4, the same selection
    unless its margin is below that); f) a bf16-stored step from that
    state against d)'s sequential, f32-stored one (the same CG iterations,
    reason and m-history bit for bit; peak memory of each); g) ``save``
    with both backends and ``load`` of each into a fresh optimizer, one
    step of the saved optimizer and of each fresh one, bitwise equal;
13. the user's front door, f32: a) a synthetic MNIST-shaped dataset
    (``train_x.npy`` [2048, 28, 28, 1] in [0, 1], ``train_y.npy`` int64)
    through ``PrefetchLoader.from_npy`` (the g++-built batcher) and
    ``DevicePrefetcher`` on the card, every batch bitwise equal to the same
    loader seed read without it, and the queue pop against a blocking copy;
    b) ``examples_torch/run_resnet18_mnist.py --data`` on that dataset in a
    subprocess started before phase 12 (full-width ResNet-18, batch 32, 2
    steps: the determinism
    self-test all true, the first step's loss down, finite losses, exit 0,
    launches equal to its CG iterations); c) All-CNN-C/CIFAR-100 as an
    ``nn.Sequential`` with explicit "SAME" padding through ``module_fns``
    (phase 8's seed-0 weights, HWIO -> OIHW; batch 128, the NHWC batch's
    channels_last view as NCHW): loss, gradient and one GGN matvec within
    rtol 1e-5 of ``allcnnc_apply`` (norm-wise), the matvec times, and 1 HF
    step on the adapter; d) ``format_solver_memory`` for ResNet-18 and
    All-CNN-C, and the estimate's f32 - bf16 iterate-store difference
    within 1 MiB of that of phase 12 f's measured peaks of requested bytes,
    its totals at most the allocated step peaks;
14. data parallelism (``parallel/``), f32 with TF32 off and
    ``cudnn.deterministic`` on: a) ``initialize_distributed`` with NCCL on
    a 1-rank group and ``make_mesh()``, one ``make_dp_hf_step`` step of the
    full-width ResNet-18/MNIST b32 from phase 6's seed-0 start, equal to
    ``hf_step`` on the same batch bit for bit (parameters, state, CG
    iterations, losses), and the NCCL ``all_reduce`` time of one
    [11,175,936] f32 vector; b) two ranks sharing the card over gloo (this
    script with ``--dp-rank``, in two subprocesses): the same ResNet-18 b32
    as two shards of 16, the reduced loss, gradient and one GGN matvec
    with each rank's BatchNorm statistics its own rows' (the ``shard_map``
    names) within relative norm 1e-5 of one process's accumulated values
    over the same two shards (their distance to the whole batch printed
    with no bound), 1 ``make_dp_hf_step`` step (BatchNorm over both ranks'
    rows, 15 e) with a finite, non-increasing loss and the two ranks'
    parameters equal bit for bit (and their CG iterations equal), the step
    time, and the gloo ``all_reduce`` time of the same vector on the card;
    c) on the same two ranks, phase 8's All-CNN-C/CIFAR-100 (b256 as 4
    chunks of 64, each chunk split 32/32, cross-entropy plus L2):
    ``dp_diag_EF`` and the accumulated GGN matvec within 1e-5 of the
    one-process ones, and one ``make_dp_hf_acc_step`` step preconditioned
    with the EMA of the diagonal, finite and non-increasing, replicas equal
    bit for bit; d) ``examples_torch/run_allcnnc_cifar100.py --dp
    --backend gloo`` under ``torch.distributed.run --nproc-per-node 2`` on
    the card, started before a), exit 0 with finite losses.  Each
    rank counts its kernel launches, which must equal its CG iterations,
    and the parent adds them;
15. the model axis (``parallel/sharded.py``), f32 with TF32 off and
    ``cudnn.deterministic`` on: a) NCCL on a 1-rank (data 1, model 1)
    mesh, one ``make_sharded_hf_step`` step of phase 6's ResNet-18 equal to
    ``hf_step`` bit for bit; b) two gloo ranks sharing the card (this
    script with ``--shard-rank``), a (data 1, model 2) mesh, the same
    ResNet-18: 1 sharded step (K1 on 5,587,968 elements per rank, replicas
    bitwise equal, a finite non-increasing loss), a 10-iteration CG solve
    of its system on the ranks' blocks within 1e-5 of one process's
    (iterate and m-history, norm-wise), the step's distance to
    one process's ``hf_step`` (no bound: f32 dots summed in two blocks can
    move Martens' stop), each rank's peak of requested bytes against one
    process's beside ``solver_memory_bytes``, and the gloo time of a CG
    iteration's collectives; c) the same ranks, the full-width decoder LM
    (b32 x T128): context parallel (``batch_specs=P(None, "model")``) loss,
    gradient and GGN matvec within 1e-5 of one process's; under the
    Megatron ``param_specs`` (each rank computes 4 of 8 heads and 1024 of
    2048 feed-forward columns per block, and 256 of 512 features of the
    embeddings and of the tied head's contraction, under the axes the
    step's plan picks) the loss, gradient, GGN and one-shot Hessian
    matvecs within 1e-5 of one process's, the ranks' gradients bitwise
    equal, each rank's forward FLOPs (``FlopCounterMode``) exactly half of
    one process's, its gathers (1) and sums (2 per block and 1 of the
    logits) per forward, and each rank's peak of requested bytes of one
    gradient + build + matvec beside the replicated-weights form's and one
    process's, and the gloo ms of a matvec in turns with that of the blocks
    alone partitioned, and of the logits sum and the stream gather that
    the embeddings and head add; a 10-iteration CG solve of the start's
    system on the ranks' blocks within 1e-5 of one process's under
    context parallelism and under the Megatron specs, and 1 step of each
    on the first 3 of the 6 blocks; each first step within 1e-5 of one
    process's ``hf_step`` where their CG iterations agree; d) the
    full-width MoE LM under ``moe_param_specs`` (4 of 8 experts per rank,
    one replicated program): loss and one GGN matvec within 1e-5 of one
    process's, each rank's forward FLOPs against the count reckoned from
    the einsums, its local tree, the gloo bytes and ms of a matvec, 1
    step on the first 2 of the 6 blocks and each rank's peak memory; e)
    fault F2, on b's
    ranks as a (data 2) mesh, ResNet-18 b32 as 2 x 16: the GSPMD names'
    reduced loss, gradient and GGN matvec (BatchNorm over both ranks' rows)
    against one process on the whole batch, in f64 (within 1e-10), in f32
    with cuDNN off (within 1e-5) and with cuDNN (within ten times cuDNN's
    own distance from the native convolutions, gradient and matvec, in one
    process on rank 0's 16 rows plus on the 32); f) ``run_sharded.py --tp``
    (each rank computing half of every layer's output columns, as it
    prints) and ``--megatron``, ``run_context_parallel.py --tiny`` and
    ``run_moe_lm.py --ep --tiny`` under
    ``torch.distributed.run --nproc-per-node 2 --backend gloo``, started
    before phase 12), each exit 0 with rank 0 printing alone; g) on b's
    ranks,
    where the model axis's roles meet: the full-width MoE LM under CP + EP
    (``moe_param_specs`` and ``batch_specs=P(None, "model")``: attention
    on each rank's 64 positions, the feed-forward routing all 4,096 tokens
    as one process does, on the rank's 4 of 8 experts), 1 step (finite,
    non-increasing, replicas bitwise, its CG iterations beside phase 11's,
    ms and each rank's peak) and its loss, gradient and GGN matvec within
    1e-5 of one process's (h's), with the top-2 choices capacity drops (>
    0), the values and the step on the first 2 of the 6 blocks, as d's
    step;
    the same values under Megatron attention + EP (the forward under the
    tensor and the expert axes: each rank's 4 of 8 heads and 4 of 8
    experts, its forward FLOPs equal to the count reckoned from the
    einsums, its local tree and peak beside EP alone's) and for the
    decoder LM under its Megatron specs + CP (the blocks computed
    gathered: the forward ran under no tensor axis, each rank's forward
    FLOPs exactly half of one process's; these are c's CP values, which
    go through this plan); fault F3: the decoder LM's first EMA
    empirical-Fisher diagonal under CP within 1e-5 of one process's
    ``diag_EF`` on the whole sequence, with its ms and each rank's peak;
    h) fault F5, on b's ranks as a (data 2, model 1) mesh: the MoE LM on
    its first 2 blocks with its rows split over the data axis (each MoE
    layer routing both ranks' rows together): the loss, gradient and GGN
    matvec within 1e-5 of one process's on the whole batch, the top-2
    choices capacity drops (> 0), each rank's forward and MoE FLOPs
    against one process's, and 1 ``make_sharded_hf_step`` step (finite,
    non-increasing, replicas bitwise, its ms and each rank's peak).
    Each rank counts its kernel launches, which must equal its CG
    iterations;
16. pipeline parallelism (``parallel/pipeline.py``), phase 10's decoder LM,
    f32 with TF32 off and ``cudnn.deterministic`` on: a) NCCL on a 1-rank
    (stage 1) mesh, one microbatch: one pipelined ``hf_step`` equal to the
    sequential ``hf_step`` bit for bit; b) two gloo ranks sharing the card
    (this script with ``--pipe-rank``, started with c) before phase 14 in
    the whole script, before a) alone), a (stage 2) mesh, 3 blocks per
    stage, 4 microbatches of 8 (a bubble of 1/5): the loss, gradient, GGN
    matvec and Hessian matvec (one-shot) within relative norm 1e-5 of one
    process's sequential ones, a 10-iteration CG solve of the start's
    system within 1e-5 of one process's, forwards at 1, 2 and 8
    microbatches and with remat within 1e-5 of the sequential forward, 1
    pipelined ``hf_step`` step (a finite, non-increasing loss, replicas
    bitwise equal) within 1e-5 of one process's where their CG iterations
    agree; the step ms against one process's, the gloo ms and bytes of
    one tick's shift (one microbatch in one all-to-all) and the ms of the
    blocks' cotangent sum, each rank's peak memory
    against one process's; c) ``examples_torch/run_pipeline_parallel.py
    --backend gloo`` under ``torch.distributed.run --nproc-per-node 4``,
    exit 0 with the loss halved.  Each rank counts its
    kernel launches, which must equal its CG iterations.

Phases 10 and 11 also read the card's busy share from a ``torch.profiler``
trace of 5 matvecs.

Phase 3 also holds the kernel against its plain version at the flat
dimensions of phases 10 and 11, at the blocks of n / 2 that each rank
of 15 b-d and g gives it, at 15 h's whole n and at the narrow examples'
n of 15 f and 16 c (f32),
and times it at each of those n beside its bound.  The ``kernels`` line
gives K1's device time at the main path's n as ``ms``, with ``call_ms``
(CUDA events around the call) and ``host_ms`` beside it, and the plain
version's device time as ``plain_ms``; it counts the kernel's launches
on the four paths (phases 6, 8, 10 and 11), the steps of phase 12,
those of phase 13 b (read from the example's output) and c, and those of
phase 14's, 15's and 16's steps on every rank; the launches of the comparisons (the
one-process references, the fixed-length solves of 15 b, c and 16 b) and
of phase 12's standalone CG solves do not count.

It needs a CUDA device, ``nvcc`` (the CUDA toolkit) and ``g++``, and
imports no JAX.  ``python3 chip_smoke.py --phase N`` builds the kernel and
runs phase N alone, for N = 3, 14, 15 or 16; none of them prints the
``kernels`` line or the ``ok`` line.
"""

from __future__ import annotations

import functools
import gc
import hashlib
import json
import math
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import pytorchhessianfree_tpu_torch as pkg
from examples_torch.example_utils import allcnnc_sequential, load_hwio_convs
from pytorchhessianfree_tpu_torch import (
    _build,
    accumulate,
    models,
    optimizer,
    runtime,
)
from pytorchhessianfree_tpu_torch.config import precision_ctx
from pytorchhessianfree_tpu_torch.ops import cg_update as ops
from pytorchhessianfree_tpu_torch.models.transformer import (
    _block,
    _layernorm,
    stack_blocks,
)
from pytorchhessianfree_tpu_torch.parallel import (
    collectives,
    data_parallel as dp,
    distributed as pdist,
    mesh as pmesh,
    pipeline,
    sharded,
)
from pytorchhessianfree_tpu_torch.ops.curvature import (
    ggnvp,
    hvp,
    value_and_grad,
)
from pytorchhessianfree_tpu_torch.utils.flatten import (
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from pytorchhessianfree_tpu_torch.utils.memory import (
    format_solver_memory,
    solver_memory_bytes,
)
from pytorchhessianfree_tpu_torch.utils.remat import checkpoint

MAIN_N = 11_175_936  # ResNet-18/MNIST flat dimension, padded to 1024
ALLCNNC_PARAMS = 1_387_108
ALLCNNC_N = 1_387_520  # All-CNN-C/CIFAR-100 flat dimension, padded to 1024
DENSE_LM_N = 19_505_152  # decoder LM parameters = flat dimension
MOE_N = 107_717_632  # MoE decoder LM parameters = flat dimension
PATH_N = {"ResNet-18": MAIN_N, "All-CNN-C": ALLCNNC_N,
          "decoder LM": DENSE_LM_N, "MoE LM": MOE_N}
# the depth of the sharded steps of 15 c (decoder LM) and 15 d (MoE LM,
# EP alone), and their flat dimensions: cut to keep the script's time
STEP_LAYERS = {"decoder LM": 3, "MoE LM": 2}
CUT_N = {"decoder LM": 10_048_512, "MoE LM": 36_299_776}
# each rank's block of a flat vector split over a model axis of 2 (15 b-d,
# g)
BLOCK_N = {f"{path} block": n // 2
           for path, n in PATH_N.items() if path != "All-CNN-C"}
BLOCK_N.update({f"{path} ({STEP_LAYERS[path]} layers) block": n // 2
                for path, n in CUT_N.items()})
# 15 h's step: the rows split over a data axis of 2, the CG space whole
BLOCK_N["MoE LM (2 layers), rows split"] = CUT_N["MoE LM"]
# the narrow examples of 15 f and 16 c: each one's TrainableRavel dim, per
# rank of the model axis of 2 where the example shards the solver
EXAMPLE_N = {"run_sharded.py --tp block": 256,
             "run_sharded.py --megatron block": 9_408,
             "run_context_parallel.py --tiny block": 9_728,
             "run_moe_lm.py --ep --tiny block": 22_528,
             "run_pipeline_parallel.py": 35_840}
NARROW_SEED = 0  # phase 7's weights and batch
RAGGED_N = 1_000_003
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2
DEVICE_CALLS = 30  # profiled K1 calls per n
# benchmarks/decoder_lm_bench.py and moe_lm_bench.py
LM = dict(vocab=1024, d_model=512, n_heads=8, n_layers=6, d_ff=2048)
RTOL_VEC = {torch.float32: 1e-6, torch.float64: 1e-13}  # FMA contraction
RTOL_DOT = {torch.float32: 1e-5, torch.float64: 1e-12}  # summation order


def close(actual, expected, rtol, what):
    torch.testing.assert_close(actual, expected, rtol=rtol, atol=0, msg=what)
    return float((actual - expected).abs().max())


def cuda_ms(fn, calls):
    """Per-call device times (ms) of ``fn``, timed with CUDA events."""
    events = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in events]


def kernel_inputs(n, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn():
        return torch.randn(n, generator=gen, device="cuda", dtype=dtype)

    x, r, p, Ap = randn(), randn(), randn(), randn()
    # b near -x keeps m = 0.5 (r' - b) . x' far from 0, so a relative
    # tolerance on it measures the summation, not a cancellation
    b = -x + 0.1 * randn()
    alpha = torch.rand((), generator=gen, device="cuda", dtype=dtype) + 0.1
    return x, r, p, Ap, b, alpha


def kernel_bound_ms(n):
    """The least time for one call at 4-byte entries: five vectors read and
    two written, over the card's memory rate."""
    return 7 * 4 * n / HBM_BYTES_PER_S * 1e3


_FLUSH = []


def l2_flush():
    """Evict the next launch's inputs from the card's 50 MB L2: write one
    256 MiB buffer, then read another, so that L2 is left holding clean
    lines (no write-back of the flush lands in the timed launch)."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(FLUSH_BYTES // 4, device="cuda")
                      for _ in range(2))
    _FLUSH[0].fill_(1.0)
    _FLUSH[1].sum()


def traced_calls(fn, calls, skip):
    """The device kernels of ``calls`` calls of ``fn``, L2 flushed before
    each, in a ``torch.profiler`` trace (device events only), split into
    calls by the flush's kernels (named in ``skip``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            l2_flush()
            fn()
        torch.cuda.synchronize()
    per_call, call = [], None
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if e.name in skip:
            call = None
        elif call is None:
            call = [e]
            per_call.append(call)
        else:
            call.append(e)
    if len(per_call) > calls:
        raise AssertionError(
            f"{len(per_call)} calls of {calls} in the trace: "
            f"{sorted({e.name for c in per_call for e in c})}")
    return per_call


def device_ms(fn, calls, skip, traces=4):
    """Median device time of one call of ``fn`` with L2 flushed before each
    call: the summed durations of the call's kernels
    (:func:`traced_calls`).  A call of which the trace lost events (CUPTI
    drops some, once 17 calls' of 30) is left out, and another trace of
    ``calls`` calls is taken, up to ``traces`` in all, until at least half
    the calls traced are whole.  Returns ``(ms, kernels per call, calls
    read, calls traced)``."""
    per_call = []
    for traced in range(calls, (traces + 1) * calls, calls):
        per_call += traced_calls(fn, calls, skip)
        k = statistics.mode(len(c) for c in per_call) if per_call else 0
        whole = [c for c in per_call if len(c) == k]
        if 2 * len(whole) >= traced:
            break
    else:
        raise AssertionError(
            f"{len(whole)} whole calls with {k} kernels of {traced} traced: "
            f"{sorted({e.name for c in per_call for e in c})}")
    ms = [sum(e.time_range.elapsed_us() for e in c) / 1e3 for c in whole]
    return statistics.median(ms), k, len(whole), traced


def flush_kernels():
    """The names of the flush's kernels in a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    l2_flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            l2_flush()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    if not names:
        raise AssertionError("torch.profiler recorded no device event")
    return names


def host_us(fn, calls=200, rounds=7):
    """Host microseconds per call of ``fn``: a host clock around ``calls``
    calls queued with no synchronise, divided by ``calls``; the best of
    ``rounds`` such rounds (the host is shared: other work only adds)."""
    rates = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        rates.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return min(rates)


def host_times(n):
    """K1 and its plain version at ``n`` in f32: the per-call CUDA-event ms
    (in turns: plain, kernel, kernel, plain) and host us."""
    args = kernel_inputs(n, torch.float32, seed=1)
    kernel = functools.partial(ops.fused_cg_update, *args)
    plain = functools.partial(ops.fused_cg_update_reference, *args)
    cuda_ms(kernel, 5)  # warm up
    cuda_ms(plain, 5)
    plain_t = cuda_ms(plain, 25)
    kernel_t = cuda_ms(kernel, 25) + cuda_ms(kernel, 25)
    plain_t += cuda_ms(plain, 25)
    return dict(call_ms=statistics.median(kernel_t),
                plain_call_ms=statistics.median(plain_t),
                host_us=host_us(kernel), plain_host_us=host_us(plain),
                bound_ms=kernel_bound_ms(n))


def device_times(n, skip):
    """K1 and its plain version at ``n`` in f32: device ms, L2 flushed."""
    args = kernel_inputs(n, torch.float32, seed=1)
    t = {}
    t["ms"], t["per_call"], t["read"], t["traced"] = device_ms(
        functools.partial(ops.fused_cg_update, *args), DEVICE_CALLS, skip)
    t["plain_ms"], _, _, _ = device_ms(
        functools.partial(ops.fused_cg_update_reference, *args),
        DEVICE_CALLS, skip)
    return t


def phase_kernel():
    """Kernel against plain on the card, at the n of every path, of every
    rank's block in phase 15, of the narrow examples and a ragged n, and its
    times at each of those but the ragged one; returns the main-size f32
    record."""
    print(_build.build_log("fused_cg_update.cu").strip())
    record = {}
    checks = [(n, dtype) for n in (MAIN_N, ALLCNNC_N, RAGGED_N, DENSE_LM_N)
              for dtype in (torch.float32, torch.float64)]
    checks += [(n, torch.float32) for n in (MOE_N, *BLOCK_N.values(),
                                            *EXAMPLE_N.values())]
    for n, dtype in checks:
        args = kernel_inputs(n, dtype, seed=n % 1000)
        ref = ops.fused_cg_update_reference(*args)
        out = ops.fused_cg_update(*args)
        again = ops.fused_cg_update(*args)
        torch.cuda.synchronize()
        errs = [
            close(out[0], ref[0], RTOL_VEC[dtype], "x'"),
            close(out[1], ref[1], RTOL_VEC[dtype], "r'"),
            close(out[2], ref[2], RTOL_DOT[dtype], "m"),
            close(out[3], ref[3], RTOL_DOT[dtype], "rr"),
        ]
        if not (torch.equal(out[2], again[2])
                and torch.equal(out[3], again[3])):
            raise AssertionError("m / rr differ between two launches")
        print(f"kernel vs plain n={n} {str(dtype)[6:]}: max abs err "
              f"x' {errs[0]:.3e} r' {errs[1]:.3e} m {errs[2]:.3e} "
              f"rr {errs[3]:.3e}; m, rr bitwise reproducible")
        if n == MAIN_N and dtype == torch.float32:
            record["max_abs_err"] = max(errs)
        del args, ref, out, again

    for dtype in (torch.float32, torch.float64):
        sm_count, per_sm, _ = ops._config(0, dtype.itemsize)
        print(f"K1 {str(dtype)[6:]}: {sm_count} SMs x {per_sm} resident "
              f"blocks of {ops.THREADS} threads; grid at the main path's n "
              f"{ops.launch_geometry(MAIN_N, dtype.itemsize, sm_count, per_sm).grid}")
    timed = {**PATH_N, **BLOCK_N, **EXAMPLE_N}
    # host times first: after the profiler has run in this process they
    # read 20-80% higher (PERF.md)
    times = {path: host_times(n) for path, n in timed.items()}
    skip = flush_kernels()
    per_call = set()
    for path, n in timed.items():
        t = times[path]
        t.update(device_times(n, skip))
        per_call.add(t["per_call"])
        print(f"fused_cg_update n={n} f32 ({path}): device "
              f"{t['ms']:.4f} ms per call ({t['per_call']} kernel(s), median "
              f"of {t['read']} of {t['traced']} calls, L2 flushed, profiler), "
              f"host {t['host_us']:.1f} us per call (best of 7 x 200 "
              f"queued), call "
              f"{t['call_ms']:.4f} ms (median of 50, CUDA events); plain: "
              f"device {t['plain_ms']:.4f} ms, host {t['plain_host_us']:.1f} "
              f"us, call {t['plain_call_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4g} ms (moves {7 * 4 * n / 1e6:.3g} MB): "
              f"device {7 * 4 * n / t['ms'] / 1e6:.4g} GB/s, "
              f"{t['bound_ms'] / t['ms']:.2%} of the bound")
        if n == MAIN_N:
            record.update(t)
    if per_call != {1}:
        raise AssertionError(f"K1 ran {per_call} kernels per call")
    return record


def phase_cg():
    """CG on the card (kernel) against CG on the CPU (plain), f64."""
    n = 4096
    rng = np.random.default_rng(0)
    q = rng.standard_normal((n, n)) / math.sqrt(n)
    a = q @ q.T + 0.1 * np.eye(n)
    b = rng.standard_normal(n)
    results = []
    for dev in ("cuda", "cpu"):
        A = torch.tensor(a, device=dev)
        res = pkg.cg(
            lambda v: A @ v,
            torch.tensor(b, device=dev),
            max_iter=60,
            martens_conv_crit=True,
            store_x_at_iters=None,
        )
        results.append(res)
    gpu, cpu = results
    if (gpu.num_iters, gpu.reason) != (cpu.num_iters, cpu.reason):
        raise AssertionError(
            f"CG differs: card {gpu.num_iters} iters reason {gpu.reason}, "
            f"CPU {cpu.num_iters} iters reason {cpu.reason}"
        )
    k = gpu.num_iters
    ex = close(gpu.x.cpu(), cpu.x, 1e-9, "CG x")
    em = close(gpu.m_hist[: k + 1].cpu(), cpu.m_hist[: k + 1], 1e-9, "m_hist")
    print(f"CG n={n} f64 card vs CPU: {k} iters, "
          f"{pkg.CG_REASON_STRINGS[gpu.reason]} on both; max abs err x "
          f"{ex:.3e} m_hist {em:.3e}")


def same_history(gpu, cpu, rtols=(1e-9, 1e-6)):
    """Card and CPU runs of the same steps: the same CG decisions, and
    losses within ``rtols[i]`` at step i (by default 1e-9 and 1e-6)."""
    for key in ("num_cg_iters", "cg_reasons", "best_cg_iters", "dampings"):
        if gpu[key] != cpu[key]:
            raise AssertionError(f"{key}: card {gpu[key]} CPU {cpu[key]}")
    for i, rtol in enumerate(rtols):
        for key in ("init_losses", "final_losses"):
            if not math.isclose(gpu[key][i], cpu[key][i], rel_tol=rtol):
                raise AssertionError(f"{key}[{i}]: {gpu[key]} vs {cpu[key]}")


def phase_small_slice():
    """Two narrow ResNet-18 HF steps on the card and on the CPU, f64."""
    gen = torch.Generator().manual_seed(1)
    params = models.init_resnet18(gen, width_scale=1 / 16,
                                  dtype=torch.float64)
    x = torch.randn((8, 28, 28, 1), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 10, (8,), generator=gen)
    runs = []
    for dev in ("cuda", "cpu"):
        opt = pkg.HessianFree(
            tree_map(lambda t: t.to(dev), params),
            model_fn=models.resnet18_apply,
            loss_outer=models.cross_entropy_loss,
            config=pkg.HFConfig(damping=1.0, cg_max_iter=10),
        )
        for _ in range(2):
            opt.step((x.to(dev), y.to(dev)))
        runs.append(opt.history)
    gpu, cpu = runs
    same_history(gpu, cpu)
    print(f"narrow ResNet-18 f64, 2 HF steps card vs CPU: cg iters "
          f"{gpu['num_cg_iters']}, dampings {gpu['dampings']} on both; "
          f"final losses {gpu['final_losses']} vs {cpu['final_losses']}")


def run_steps(opt, batch, steps, path, each=None, **step_kwargs):
    """``steps`` HF steps of ``opt`` on ``batch`` (``opt.step(batch,
    **step_kwargs)``), each printed and passed to ``each(stats)``; fails on
    a non-finite loss, a step whose final loss exceeds its initial loss, or
    kernel launches other than the CG iterations.  Returns the launches."""
    first = len(opt.history["init_losses"])
    ops.fused_cg_update.launches = 0
    for i in range(first, first + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(batch, **step_kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        s, h = opt.last_stats, opt.history
        if each is not None:
            each(s)
        print(f"step {i}: loss {h['init_losses'][i]:.6f} -> "
              f"{h['final_losses'][i]:.6f} | damping {float(s.damping):.6f} "
              f"-> {float(s.new_damping):.6f} | cg {s.num_cg_iters} iters "
              f"({h['cg_reasons'][i]}) | best iter {s.best_cg_iter} | lr "
              f"{h['learning_rates'][i]:.6f} | {ms:.1f} ms")
    launches = ops.fused_cg_update.launches
    h = {k: v[first:] for k, v in opt.history.items()}
    losses = h["init_losses"] + h["final_losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for i, (a, b) in enumerate(zip(h["init_losses"], h["final_losses"])):
        if not b <= a:
            raise AssertionError(f"step {i}: final loss {b} > init {a}")
    if launches != sum(h["num_cg_iters"]):
        raise AssertionError(
            f"fused_cg_update launched {launches} times for "
            f"{sum(h['num_cg_iters'])} CG iterations"
        )
    print(f"fused_cg_update launches on {path}: {launches} = total CG "
          f"iterations {h['num_cg_iters']}")
    return launches


def resnet_main_path(**config):
    """``HessianFree`` on full-width ResNet-18/MNIST b32 as ``bench.py``
    builds it, ``HFConfig(damping=1.0, cg_max_iter=50, **config)``, with
    the seed-0 weights and batch; returns ``(opt, batch, generator)``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_resnet18(gen, device="cuda")
    count = sum(t.numel() for t in tree_flatten(params)[0])
    if count != 11_175_370:
        raise AssertionError(f"ResNet-18 has {count} parameters")
    x = torch.randn((32, 28, 28, 1), generator=gen, device="cuda")
    y = torch.randint(0, 10, (32,), generator=gen, device="cuda")
    return resnet_opt(params, **config), (x, y), gen


def resnet_opt(params, **config):
    """``HessianFree`` on ResNet-18 with the main path's configuration."""
    return pkg.HessianFree(
        params,
        model_fn=models.resnet18_apply,
        loss_outer=models.cross_entropy_loss,
        config=pkg.HFConfig(damping=1.0, cg_max_iter=50, **config),
        pad_to_multiple=1024,
    )


def phase_main():
    """The main path: 1 HF step of full-width ResNet-18/MNIST b32."""
    opt, (x, y), gen = resnet_main_path()
    count = opt.ravel.unpadded_dim
    if opt.ravel.dim != MAIN_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    print(f"main path: ResNet-18, {count} parameters, flat dim "
          f"{opt.ravel.dim}, batch 32 x 28x28x1, GGN, cg_max_iter=50, f32")

    launches = run_steps(opt, (x, y), 1, "the main path")

    # GGN matvec time as the step builds it, and the per-matvec jvp form
    # (which recomputes the primal forward in every matvec) beside it
    batch = (x, y)
    t0 = time.perf_counter()
    _, grad_vec, mvp = optimizer._build_matvec_and_grad(
        opt.fns, opt.config, opt.ravel, opt.params, batch
    )
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3

    def model_at(p):
        return models.resnet18_apply(p, x)

    t0 = time.perf_counter()
    outputs, vjp_fn = torch.func.vjp(model_at, opt.params)
    loss_grad = torch.func.grad(lambda o: models.cross_entropy_loss(o, y))
    torch.cuda.synchronize()
    jvp_build_ms = (time.perf_counter() - t0) * 1e3

    def jvp_mvp(v):
        tangent = opt.ravel.unravel(v)
        Jv = torch.func.jvp(model_at, (opt.params,), (tangent,))[1]
        HJv = torch.func.jvp(loss_grad, (outputs,), (Jv,))[1]
        return opt.ravel.ravel(vjp_fn(HJv)[0])

    v = torch.randn(opt.ravel.dim, generator=gen, device="cuda")
    # norm-wise: f32 rounding of the two forms makes near-zero entries
    # differ by any relative amount
    err = float(torch.linalg.vector_norm(jvp_mvp(v) - mvp(v))
                / torch.linalg.vector_norm(mvp(v)))
    if not err <= 1e-4:
        raise AssertionError(f"jvp-form GGN matvec: relative error {err}")
    times = cuda_ms(lambda: mvp(v), 20)
    jvp_times = cuda_ms(lambda: jvp_mvp(v), 20)
    print(f"GGN matvec (as in the step): median {statistics.median(times):.3f}"
          f" ms over 20 (CUDA events); per-batch build {build_ms:.1f} ms")
    print(f"GGN matvec (jvp per matvec): median "
          f"{statistics.median(jvp_times):.3f} ms over 20; per-batch build "
          f"{jvp_build_ms:.1f} ms; relative to the step's form {err:.2e}")

    # the CG solve of a step on its own, at the state the 3 steps left
    damping = opt.state.damping
    t0 = time.perf_counter()
    res = pkg.cg(lambda u: mvp(u) + damping * u, -grad_vec, x0=opt.state.x0,
                 max_iter=50, martens_conv_crit=True, store_x_at_iters=None)
    torch.cuda.synchronize()
    cg_ms = (time.perf_counter() - t0) * 1e3
    print(f"CG solve alone (next step's system): {res.num_iters} iters, "
          f"{cg_ms:.1f} ms = {cg_ms / res.num_iters:.2f} ms per iteration")
    return launches


def allcnnc_opt(params, **config):
    """``HessianFree`` on All-CNN-C with cross-entropy plus DeepOBS' L2."""
    return pkg.HessianFree(
        params,
        model_fn=models.allcnnc_apply,
        loss_outer=models.cross_entropy_loss,
        loss_reg=models.l2_regularizer,
        config=pkg.HFConfig(**config),
        pad_to_multiple=1024,
    )


def phase_allcnnc_narrow():
    """Two narrow All-CNN-C ``acc_step``s with the empirical-Fisher
    diagonal on the card and on the CPU, f64."""
    gen = torch.Generator().manual_seed(NARROW_SEED)
    params = models.init_allcnnc(gen, width_scale=1 / 8, dtype=torch.float64)
    # inputs at a tenth of unit scale keep this narrow system well
    # conditioned, so CG stops on its tolerance: at unit scale some draws
    # run CG into iterates that carry last-bit differences up 100x per
    # iteration, and two correct runs part in the third decimal
    x = 0.1 * torch.randn((16, 32, 32, 3), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 100, (16,), generator=gen)
    runs = []
    for dev in ("cuda", "cpu"):
        opt = allcnnc_opt(tree_map(lambda t: t.to(dev), params), damping=1.0,
                          cg_max_iter=10, precond_exponent=0.6)
        xd, yd = x.to(dev), y.to(dev)
        data = [(xd[:8], yd[:8]), (xd[8:], yd[8:])]
        for _ in range(2):
            diag = opt.get_preconditioner(xd, yd, "mean")
            opt.acc_step(data, precond_diag=diag)
        runs.append(opt.history)
    gpu, cpu = runs
    same_history(gpu, cpu)
    print(f"narrow All-CNN-C f64, 2 preconditioned acc_steps card vs CPU: cg "
          f"iters {gpu['num_cg_iters']} ({gpu['cg_reasons']}), dampings "
          f"{gpu['dampings']} on both; final losses {gpu['final_losses']} vs "
          f"{cpu['final_losses']}")


def phase_allcnnc():
    """The accumulated path: 2 preconditioned ``acc_step``s of the
    full-width All-CNN-C on CIFAR-100 shapes, batch 256 in 4 chunks.
    Returns the kernel launches and the accumulated matvec's median ms."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_allcnnc(gen, device="cuda")
    count = sum(t.numel() for t in tree_flatten(params)[0])
    if count != ALLCNNC_PARAMS:
        raise AssertionError(f"All-CNN-C has {count} parameters")
    x = torch.randn((256, 32, 32, 3), generator=gen, device="cuda")
    y = torch.randint(0, 100, (256,), generator=gen, device="cuda")
    opt = allcnnc_opt(params, damping=1.0, cg_max_iter=50)
    if opt.ravel.dim != ALLCNNC_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    chunks = [(x[i:i + 64], y[i:i + 64]) for i in range(0, 256, 64)]
    mvp_data = chunks[:2]  # curvature on half the gradient's batch
    print(f"accumulated path: All-CNN-C, {count} parameters, flat dim "
          f"{opt.ravel.dim}, batch 256 x 32x32x3 as 4 chunks of 64 (matvec "
          f"on 2), CE + L2 5e-4, GGN, cg_max_iter=50, EMA(0.9) diag_EF "
          f"preconditioner, f32")

    # The self-test holds every entry of the accumulated loss, gradient and
    # matvec to the reference's rtol 1e-2 / atol 1e-4 against the
    # concatenated batch.  In f32 at this size the chunked and concatenated
    # matvecs differ by ~6e-5 of the matvec's norm (5e-16 in f64), which
    # near-zero entries exceed; so it runs on an f64 copy of the same model
    # and data.
    opt64 = allcnnc_opt(tree_map(lambda t: t.double(), params), damping=1.0,
                        cg_max_iter=50)
    chunks64 = [(a.double(), b) for a, b in chunks]
    opt64.test_reduction(chunks64, "mean")
    try:
        opt64.test_reduction(chunks64, "sum")
    except RuntimeError:
        pass
    else:
        raise AssertionError("test_reduction(..., 'sum') did not raise")
    del opt64, chunks64
    print("reduction self-test (f64 copy): 'mean' passes, 'sum' raises")

    ema = pkg.EMADiag(0.9)
    starts = []
    ops.fused_cg_update.launches = 0
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        diag = ema.update(opt.get_preconditioner(x, y, "mean"))
        starts.append((opt.params, opt.state, diag))
        opt.acc_step(chunks, chunks, mvp_data, precond_diag=diag)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        s, h = opt.last_stats, opt.history
        print(f"step {i}: loss {h['init_losses'][i]:.6f} -> "
              f"{h['final_losses'][i]:.6f} | damping {float(s.damping):.6f} "
              f"-> {float(s.new_damping):.6f} | cg {s.num_cg_iters} iters "
              f"({h['cg_reasons'][i]}) | best iter {s.best_cg_iter} | lr "
              f"{h['learning_rates'][i]:.6f} | {ms:.1f} ms with the diagonal")
    launches = ops.fused_cg_update.launches
    h = opt.history
    losses = h["init_losses"] + h["final_losses"]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for i, (a, b) in enumerate(zip(h["init_losses"], h["final_losses"])):
        if not b <= a:
            raise AssertionError(f"step {i}: final loss {b} > init {a}")
    if launches != sum(h["num_cg_iters"]):
        raise AssertionError(
            f"fused_cg_update launched {launches} times for "
            f"{sum(h['num_cg_iters'])} CG iterations"
        )
    print(f"fused_cg_update launches on the accumulated path: {launches} = "
          f"total CG iterations {h['num_cg_iters']}")

    # each step again from its starting point, for a median of 10
    for i, (params_i, state_i, diag_i) in enumerate(starts):
        iters = []

        def step():
            stats = optimizer.hf_acc_step(
                params_i, state_i, fns=opt.fns, config=opt.config,
                ravel=opt.ravel, loss_data=chunks, grad_data=chunks,
                mvp_data=mvp_data, precond_diag=diag_i,
                precond_exponent=opt.config.precond_exponent,
            )[2]
            iters.append(stats.num_cg_iters)

        median = statistics.median(cuda_ms(step, 10))
        print(f"step {i} again from its start: median {median:.1f} ms over "
              f"10 (CUDA events), CG iterations {iters}")
    times = cuda_ms(lambda: opt.get_preconditioner(x, y, "mean"), 10)
    print(f"diag_EF (vmap, 256 samples, [256, {opt.ravel.dim}] f32): median "
          f"{statistics.median(times):.2f} ms over 10 (CUDA events)")
    mvp = accumulate.make_acc_mvp(opt.fns, opt.config, opt.params, mvp_data,
                                  "mean", opt.ravel)
    v = torch.randn(opt.ravel.dim, generator=gen, device="cuda")
    acc_ms = statistics.median(cuda_ms(lambda: mvp(v), 10))
    print(f"accumulated GGN matvec (2 chunks of 64, jvp + vjp per chunk): "
          f"median {acc_ms:.2f} ms over 10 (CUDA events), "
          f"{acc_ms / 2:.2f} ms per chunk")
    return launches, acc_ms


def affine_tokens(gen, batch, T, vocab, device):
    """The affine next-token rule of benchmarks/decoder_lm_bench.py:
    a random first token, then ``t' = (37 t + 11) mod vocab``."""
    toks = [torch.randint(0, vocab, (batch,), generator=gen,
                          device=gen.device).to(device)]
    for _ in range(T - 1):
        toks.append((37 * toks[-1] + 11) % vocab)
    return torch.stack(toks, dim=1)


def lm_opt(params, apply, **config):
    """``HessianFree`` on a decoder LM with the next-token loss."""
    return pkg.HessianFree(
        params, model_fn=apply, loss_outer=models.next_token_loss,
        config=pkg.HFConfig(**config), pad_to_multiple=1024,
    )


def gib(nbytes):
    return nbytes / 2**30


def phase_lm_narrow():
    """The narrow decoder LM and MoE LM, 1 HF step each on the card and on
    the CPU in f64, and the narrow encoder classifier's forward."""
    gen = torch.Generator().manual_seed(NARROW_SEED)
    narrow = dict(vocab=32, d_model=32, n_layers=2, d_ff=64, max_len=16,
                  dtype=torch.float64)
    tokens = affine_tokens(gen, 8, 16, 32, "cpu")
    lms = (
        ("decoder LM", models.init_decoder_lm(gen, **narrow),
         models.decoder_lm_apply),
        ("MoE LM", models.init_moe_decoder_lm(gen, n_experts=4, **narrow),
         models.moe_decoder_lm_apply),
    )
    for name, params, apply in lms:
        runs = []
        for dev in ("cuda", "cpu"):
            opt = lm_opt(tree_map(lambda t: t.to(dev), params), apply,
                         damping=1.0, cg_max_iter=10)
            opt.step((tokens.to(dev), tokens.to(dev)))
            runs.append(opt.history)
        gpu, cpu = runs
        same_history(gpu, cpu, rtols=(1e-9,))
        print(f"narrow {name} f64, 1 HF step card vs CPU: cg iters "
              f"{gpu['num_cg_iters']} ({gpu['cg_reasons']}), dampings "
              f"{gpu['dampings']} on both; final losses "
              f"{gpu['final_losses']} vs {cpu['final_losses']}")
    params = models.init_transformer(gen, num_classes=4, **narrow)
    logits = [
        models.transformer_apply(tree_map(lambda t: t.to(dev), params),
                                 tokens.to(dev)).cpu()
        for dev in ("cuda", "cpu")
    ]
    err = close(logits[0], logits[1], 1e-10, "encoder logits")
    print(f"narrow encoder classifier f64 forward card vs CPU: logits "
          f"{tuple(logits[0].shape)}, max abs err {err:.3e}")


def device_busy(fn, calls):
    """The card's busy share over ``calls`` calls of ``fn`` under
    ``torch.profiler``, as text: the summed durations of its kernels and
    copies (one stream, so they do not overlap) over the host clock around
    the calls, profiler on; "not measured" if the trace holds no device
    event."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device events only: host events of a whole step would take the
    # profiler minutes to process
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return "not measured (no device event in the trace)"
    busy = sum(device) / 1e3
    return f"{busy / wall:.1%} ({busy:.1f} of {wall:.1f} ms)"


def lm_matvec(opt, batch, gen, label):
    """The step's GGN matvec at the optimizer's params: build ms and the
    median matvec ms of 20 (CUDA events)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, mvp = optimizer._build_matvec_and_grad(
        opt.fns, opt.config, opt.ravel, opt.params, batch
    )
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    v = torch.randn(opt.ravel.dim, generator=gen, device="cuda")
    times = cuda_ms(lambda: mvp(v), 20)
    print(f"{label} GGN matvec: median {statistics.median(times):.3f} ms "
          f"over 20 (CUDA events); per-batch build {build_ms:.1f} ms")
    print(f"{label} GGN matvec, 5 under torch.profiler: device busy "
          f"{device_busy(lambda: mvp(v), 5)}")


def cosine(a, b):
    return float(a @ b / (torch.linalg.vector_norm(a)
                          * torch.linalg.vector_norm(b)))


def phase_decoder_lm():
    """1 HF step of the full-width decoder LM, a bf16-curvature step from
    the same start, and the long-sequence chunked matvec."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_decoder_lm(gen, max_len=128, **LM)
    count = sum(t.numel() for t in tree_flatten(params)[0])
    if count != DENSE_LM_N:
        raise AssertionError(f"decoder LM has {count} parameters")
    tokens = affine_tokens(gen, 32, 128, LM["vocab"], "cuda")
    batch = (tokens, tokens)
    apply = functools.partial(models.decoder_lm_apply, n_heads=LM["n_heads"])
    opt = lm_opt(params, apply, damping=1.0, cg_max_iter=50)
    if opt.ravel.dim != DENSE_LM_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    print(f"decoder LM path: {count} parameters (tied head), flat dim "
          f"{opt.ravel.dim}, batch 32 x T 128 of the affine rule on vocab "
          f"1024, next-token loss, GGN, cg_max_iter=50, f32")
    start = opt.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = run_steps(opt, batch, 1, "the decoder LM path")
    print(f"decoder LM step: peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB")
    lm_matvec(opt, batch, gen, "decoder LM")

    # bf16 curvature from the same start: matvec against f32, then a step
    v = torch.randn(opt.ravel.dim, generator=gen, device="cuda")
    mvps = []
    for cdtype in (None, "bfloat16"):
        config = pkg.HFConfig(damping=1.0, cg_max_iter=50,
                              curvature_dtype=cdtype)
        mvps.append(optimizer._build_matvec_and_grad(
            opt.fns, config, opt.ravel, start, batch)[2](v))
    cos = cosine(mvps[0], mvps[1])
    if not cos > 0.99 or mvps[1].dtype != torch.float32:
        raise AssertionError(f"bf16 matvec: cosine {cos}, {mvps[1].dtype}")
    print(f"bf16-curvature GGN matvec at the start vs f32: cosine {cos:.6f}")
    del mvps
    bf16 = lm_opt(start, apply, damping=1.0, cg_max_iter=50,
                  curvature_dtype="bfloat16")
    launches += run_steps(bf16, batch, 1, "the bf16-curvature step")
    lm_matvec(bf16, batch, gen, "bf16-curvature")
    del opt, bf16, start, params
    phase_long_sequence(gen)
    return launches


def phase_long_sequence(gen):
    """T 1024, batch 4: the matvec with ``attn_chunk=256`` against full
    attention, with the peak memory of each, in steps: chunking under
    ``linearize``; the one-shot matvec that ``HFConfig(remat=True)`` builds,
    without its checkpoints; and with them (blocks and whole model)."""
    params = models.init_decoder_lm(gen, max_len=1024, **LM)
    tokens = affine_tokens(gen, 4, 1024, LM["vocab"], "cuda")
    ravel = pkg.TrainableRavel(params, pad_to_multiple=1024)
    v = torch.randn(ravel.dim, generator=gen, device="cuda")

    def fns(**kwargs):
        return pkg.HFModelFns(
            model_fn=functools.partial(models.decoder_lm_apply,
                                       n_heads=LM["n_heads"], **kwargs),
            loss_outer=models.next_token_loss,
        )

    def build(fns, config):
        return optimizer._build_matvec_and_grad(
            fns, config, ravel, params, (tokens, tokens))[2]

    def one_shot(fns):
        """``HFConfig(remat=True)``'s gradient and matvec, unwrapped."""
        def model_at(p):
            return fns.model_fn(p, tokens)

        def outer(out):
            return fns.loss_outer(out, tokens)

        value_and_grad(lambda p: outer(model_at(p)), params)
        return lambda u: ravel.ravel(
            ggnvp(model_at, outer, params, ravel.unravel(u)))

    out = {}
    for label, make in (
        ("full attention, linearized",
         lambda: build(fns(), pkg.HFConfig())),
        ("attn_chunk=256, linearized",
         lambda: build(fns(attn_chunk=256), pkg.HFConfig())),
        ("attn_chunk=256, one-shot",
         lambda: one_shot(fns(attn_chunk=256))),
        ("attn_chunk=256, one-shot, remat",
         lambda: build(fns(attn_chunk=256, remat=True),
                       pkg.HFConfig(remat=True))),
    ):
        gc.collect()  # the previous linearized graph sits in a cycle
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mvp = make()
        out[label] = mvp(v)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        times = cuda_ms(lambda: mvp(v), 5)
        print(f"T 1024 b4, {label}: GGN matvec median "
              f"{statistics.median(times):.2f} ms over 5 (CUDA events); "
              f"peak memory of gradient + build + matvec {gib(peak):.2f} GiB "
              f"above {gib(base):.2f} GiB")
        del mvp
    full, *chunked = out.items()
    for label, mv in chunked:
        err = float(torch.linalg.vector_norm(mv - full[1])
                    / torch.linalg.vector_norm(full[1]))
        if not err <= 1e-5:
            raise AssertionError(f"{label} matvec: relative error {err}")
        print(f"T 1024: {label} matvec vs full attention, relative error "
              f"{err:.2e} (norm-wise)")


def phase_moe_lm():
    """1 HF step of the full-width MoE decoder LM."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_moe_decoder_lm(gen, n_experts=8, max_len=128, **LM)
    count = sum(t.numel() for t in tree_flatten(params)[0])
    if count != MOE_N:
        raise AssertionError(f"MoE LM has {count} parameters")
    tokens = affine_tokens(gen, 32, 128, LM["vocab"], "cuda")
    batch = (tokens, tokens)
    apply = functools.partial(models.moe_decoder_lm_apply,
                              n_heads=LM["n_heads"], capacity_factor=1.25,
                              router_groups=1, top_k=2)
    opt = lm_opt(params, apply, damping=1.0, cg_max_iter=50)
    if opt.ravel.dim != MOE_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    print(f"MoE LM path: {count} parameters, 8 experts, top-2, capacity "
          f"1.25, 1 router group, batch 32 x T 128, GGN, cg_max_iter=50, f32")
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = run_steps(opt, batch, 1, "the MoE LM path")
    print(f"MoE LM steps: peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB")
    lm_matvec(opt, batch, gen, "MoE LM")
    return launches


def requested_bytes(which):
    """The caching allocator's ``current`` or ``peak`` sum of the sizes
    tensors asked for (its allocated bytes count whole blocks instead)."""
    return torch.cuda.memory_stats()[f"requested_bytes.all.{which}"]


def with_peak(fn):
    """``(fn(), ms, peak, requested)``: the host-clock time of ``fn``, the
    peak device memory it allocates above what was allocated before it
    (``max_memory_allocated``), and the peak of the bytes its tensors
    request above the same start.  It starts from an empty allocator
    cache: a tensor served from a cached block keeps up to 1 MiB of the
    block beside it, so with a cache left by earlier work the same step's
    allocated peak moved by 19 MB from run to run (the requested bytes do
    not depend on the blocks)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_requested = requested_bytes("current")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return (out, ms, torch.cuda.max_memory_allocated() - base,
            requested_bytes("peak") - base_requested)


def walk_margin(bt_f):
    """The smallest relative gap between a loss that the sequential
    backtracking walk compared and the running minimum it compared it
    with; inf if it compared none."""
    walked = [v for v in reversed(bt_f.tolist()) if not math.isnan(v)]
    gaps, f_min = [], walked[0]
    for v in walked[1:]:
        gaps.append(abs(v - f_min) / abs(f_min))
        f_min = min(f_min, v)
    return min(gaps, default=math.inf)


def armijo_margin(stats, grad, delta, c):
    """The smallest relative gap between a loss the sequential line search
    tried and its Armijo bound ``f0 + alpha * c * grad . step``, with the
    step recovered from the update ``delta = lr * step``; inf if no step
    was taken."""
    lr, f0 = float(stats.lr), float(stats.init_loss)
    if lr == 0:
        return math.inf
    c_dir = c * float(grad @ delta) / lr
    return min(
        abs(f - (f0 + a * c_dir)) / abs(f0)
        for a, f in zip(stats.detail.ls_alphas.tolist(),
                        stats.detail.ls_f.tolist())
        if not math.isnan(f)
    )


def phase_resnet_features():
    """Phase 12: the Nystrom sketch, the spectrum, preconditioned and
    bf16-stored CG, rich stats, the batched selection and checkpoints on
    the main path (see the module docstring).  Returns the kernel launches
    of its steps and f)'s step peaks above the baseline, allocated and
    requested, by store dtype."""
    torch.backends.cudnn.deterministic = True  # for the bitwise checks
    opt, batch, _ = resnet_main_path(rich_stats=True)
    ravel = opt.ravel
    n = ravel.unpadded_dim
    print(f"phase 12: ResNet-18/MNIST b32 as in phase 6 (flat dim "
          f"{ravel.dim}, {n} parameters), rich_stats, cuDNN deterministic")

    # a) the sketch of the GGN at the start
    def sketch_gen():
        return torch.Generator("cuda").manual_seed(1)

    sketch, ms, peak, _ = with_peak(lambda: opt.get_nystrom_sketch(
        batch, rank=32, generator=sketch_gen()))
    U, eigs = sketch
    orth = float((U.T @ U - torch.eye(32, device="cuda")).abs().max())
    # the build's share, then the sketch again from the built matvec
    (_, grad, mvp), build_ms, _, _ = with_peak(
        lambda: optimizer._build_matvec_and_grad(
            opt.fns, opt.config, ravel, opt.params, batch))
    probes = pkg.normalized_probes(sketch_gen(), 32, n, ravel.dtype,
                                   pad_to=ravel.dim)
    again, again_ms, _, _ = with_peak(
        lambda: pkg.nystrom_sketch(mvp, probes))
    again_err = float(((again.eigs - eigs).abs() / eigs).max())
    u1 = U[:, 0]
    top = float(u1 @ mvp(u1))
    e = eigs.tolist()
    if not (min(e) >= 0 and all(a >= b for a, b in zip(e, e[1:]))
            and orth <= 1e-4 and top >= e[0] * (1 - 1e-3)):
        raise AssertionError(f"sketch: eigs {e}, |U^T U - I| {orth}, "
                             f"u1^T A u1 {top}")
    print(f"a) rank-32 Nystrom sketch: build {ms:.1f} ms, peak "
          f"{gib(peak):.2f} GiB above the baseline; eigs {e[0]:.6g} .. "
          f"{e[-1]:.6g}, all >= 0 and descending; |U^T U - I|_max "
          f"{orth:.2e}; u1^T A u1 = {top:.6g} >= eigs[0]; of it: the "
          f"matvec build (loss, gradient, linearize) {build_ms:.1f} ms, the "
          f"sketch from the built matvec {again_ms:.1f} ms (eigs within "
          f"{again_err:.1e} of the first)")
    del again

    # e) the spectrum at the same parameters
    def spec_gen():
        return torch.Generator("cuda").manual_seed(2)

    (ritz_res, (nodes, weights)), ms, peak, _ = with_peak(
        lambda: opt.estimate_spectrum(batch, num_iters=32, num_probes=4,
                                      generator=spec_gen()))
    probes = pkg.normalized_probes(spec_gen(), 5, n, ravel.dtype,
                                   pad_to=ravel.dim)[1:]
    # v^T A v through the batched matvec that SLQ's Lanczos runs make, and
    # through the single one
    quad = n * float((torch.func.vmap(mvp)(probes) * probes).sum(1).mean())
    single = n * statistics.fmean(float(v @ mvp(v)) for v in probes)
    trace = float(pkg.slq_trace(nodes, weights, n))
    if not math.isclose(trace, quad, rel_tol=1e-4):
        raise AssertionError(f"SLQ trace {trace} vs dim * mean v^T A v {quad}")
    vals = ritz_res.values.tolist()
    bounds = ritz_res.residual_bounds.tolist()
    print(f"e) 32-step Lanczos + 4-probe SLQ: {ms:.1f} ms, peak "
          f"{gib(peak):.2f} GiB above the baseline; Ritz values "
          f"{', '.join(f'{v:.6g}' for v in vals[:5])} ... {vals[-1]:.6g}; "
          f"residual bounds {bounds[0]:.3g} (top), {max(bounds):.3g} (max); "
          f"lambda_max {vals[0]:.6g} beside the sketch's eigs[0] "
          f"{e[0]:.6g}; SLQ trace {trace:.6g} = dim * mean v^T A v "
          f"{quad:.6g} (rtol 1e-4; {single:.6g} through single matvecs)")

    # b) the next step's damped system: plain, bf16-stored, preconditioned
    damping = opt.state.damping

    def A(v):
        return mvp(v) + damping * v

    kw = dict(x0=opt.state.x0, max_iter=50, martens_conv_crit=True,
              store_x_at_iters=None)
    plain = pkg.cg(A, -grad, **kw)
    low = pkg.cg(A, -grad, store_dtype="bfloat16", **kw)
    pre = pkg.cg(A, -grad, M=pkg.nystrom_to_preconditioner(sketch, damping),
                 **kw)
    if not ((low.num_iters, low.reason) == (plain.num_iters, plain.reason)
            and torch.equal(low.x, plain.x)
            and torch.equal(low.m_hist, plain.m_hist)
            and low.x_buf.dtype == torch.bfloat16
            and torch.equal(low.x_buf, plain.x_buf.to(torch.bfloat16))):
        raise AssertionError("bf16-stored CG differs from the f32-stored one")
    print(f"b) the damped system at damping {float(damping):g}: CG "
          f"{plain.num_iters} iters ({pkg.cg_reason_str(plain.reason)}); "
          f"Nystrom-preconditioned {pre.num_iters} iters "
          f"({pkg.cg_reason_str(pre.reason)}); bf16-stored: the same "
          f"iterations, x and m-history bit for bit, x_buf "
          f"{str(low.x_buf.dtype)[6:]} {tuple(low.x_buf.shape)}")
    del plain, low, pre, mvp, grad

    # c) two Nystrom-preconditioned steps with rich stats
    def detail_finite(s):
        m = s.detail.m_hist[: s.num_cg_iters + 1]
        if not bool(torch.isfinite(m).all()):
            raise AssertionError(f"m-history not finite: {m}")

    launches = run_steps(opt, batch, 1, "phase 12's preconditioned step",
                         each=detail_finite, precond_lowrank=sketch)
    text = pkg.format_rich_stats(opt.last_stats).splitlines()
    m_lines = [ln for ln in text if "  m = " in ln]
    rest = [ln for ln in text if "  m = " not in ln]
    print(f"c) format_rich_stats of the last step, {len(text)} lines; "
          f"{rest[0]} {m_lines[0].strip()} ... {m_lines[-1].strip()}")
    print("\n".join(rest[1:]))
    del sketch

    # d) sequential and batched selection from one saved state; the
    # sequential step is also f)'s f32-stored one (the default
    # configuration), with its peak
    saved, start = opt.state_dict(), opt.params
    runs = {}
    stats, peaks = {}, {"allocated": {}, "requested": {}}
    for mode in ("sequential", "batched"):
        o = resnet_opt(start, rich_stats=True, backtracking_mode=mode,
                       linesearch=pkg.LineSearchConfig(mode=mode))
        o.load_state_dict(saved)
        steps, _, allocated, requested = with_peak(functools.partial(
            run_steps, o, batch, 1, f"the {mode} selection step"))
        launches += steps
        runs[mode] = o
        if mode == "sequential":
            peaks["allocated"][None] = allocated
            peaks["requested"][None] = requested
            stats[None] = o.last_stats
    seq, bat = (runs[m].last_stats for m in ("sequential", "batched"))
    if (seq.num_cg_iters, seq.cg_reason) != (bat.num_cg_iters, bat.cg_reason):
        raise AssertionError("the two selection modes ran other CG solves")
    diffs = []
    for name in ("bt_f", "ls_f"):
        a, b = getattr(seq.detail, name), getattr(bat.detail, name)
        both = ~(torch.isnan(a) | torch.isnan(b))
        diffs.append(float(((a - b).abs() / b.abs())[both].max()))
    _, g_tree = value_and_grad(lambda p: opt.fns.full_loss(p, batch), start)
    bt_margin = walk_margin(seq.detail.bt_f)
    ls_margin = armijo_margin(
        seq, ravel.ravel(g_tree),
        ravel.ravel(runs["sequential"].params) - ravel.ravel(start),
        opt.config.linesearch.c)
    same_bt = seq.best_cg_iter == bat.best_cg_iter
    same_lr = math.isclose(float(seq.lr), float(bat.lr), rel_tol=1e-6)
    if not (max(diffs) <= 1e-4 and (same_bt or bt_margin <= 1e-4)
            and (same_lr or ls_margin <= 1e-4)):
        raise AssertionError(
            f"selection: shared losses differ by {diffs}; best iter "
            f"{seq.best_cg_iter} vs {bat.best_cg_iter} (margin {bt_margin}),"
            f" lr {float(seq.lr)} vs {float(bat.lr)} (margin {ls_margin})")
    evaluated = [int((~torch.isnan(s.detail.bt_f)).sum()) for s in (seq, bat)]
    print(f"d) sequential vs batched selection from one state: "
          f"{seq.num_cg_iters} CG iters on both; best iter "
          f"{seq.best_cg_iter} vs {bat.best_cg_iter}, lr {float(seq.lr):.6f}"
          f" vs {float(bat.lr):.6f}; backtracking losses evaluated "
          f"{evaluated[0]} vs {evaluated[1]}; shared losses within "
          f"{max(diffs):.2e} (rtol 1e-4); margins: walk {bt_margin:.2e}, "
          f"Armijo {ls_margin:.2e}")
    del runs, seq, bat, g_tree

    # f) a bf16-stored step against d)'s f32-stored one
    store = "bfloat16"
    o = resnet_opt(start, rich_stats=True, cg=pkg.CGConfig(store_dtype=store))
    o.load_state_dict(saved)
    steps, _, peaks["allocated"][store], peaks["requested"][store] = \
        with_peak(functools.partial(run_steps, o, batch, 1,
                                    "the bfloat16-stored step"))
    launches += steps
    stats[store] = o.last_stats
    del o
    a, b = stats[None], stats["bfloat16"]
    if not ((a.num_cg_iters, a.cg_reason) == (b.num_cg_iters, b.cg_reason)
            and torch.equal(a.detail.m_hist, b.detail.m_hist)):
        raise AssertionError("the bf16-stored step ran another CG solve")
    print(f"f) bf16- vs f32-stored iterates: {a.num_cg_iters} CG iters "
          f"({pkg.cg_reason_str(a.cg_reason)}) and the m-history bit for bit "
          f"on both; best iter {a.best_cg_iter} vs {b.best_cg_iter}; peak "
          f"of the step above the baseline, allocated "
          f"{gib(peaks['allocated'][None]):.3f} vs "
          f"{gib(peaks['allocated']['bfloat16']):.3f} GiB "
          f"({peaks['allocated'][None]} vs {peaks['allocated']['bfloat16']} "
          f"bytes), requested {peaks['requested'][None]} vs "
          f"{peaks['requested']['bfloat16']} bytes")
    del stats, a, b, start

    # g) save with both backends, load each into a fresh optimizer, one
    # step each and one of the saved optimizer
    with tempfile.TemporaryDirectory() as tmp:
        loaded = {}
        for backend in ("torch", "npz"):
            path = os.path.join(tmp, f"ckpt-{backend}")
            opt.save(path, backend=backend)
            loaded[backend] = resnet_opt(opt.params, rich_stats=True)
            loaded[backend].load(path, backend=backend)
        launches += run_steps(opt, batch, 1, "the saved optimizer")
        for backend, fresh in loaded.items():
            launches += run_steps(fresh, batch, 1, f"the {backend}-loaded one")
            if not (opt.history == fresh.history
                    and torch.equal(ravel.ravel(opt.params),
                                    ravel.ravel(fresh.params))
                    and all(torch.equal(x, y)
                            for x, y in zip(opt.state, fresh.state))):
                raise AssertionError(f"{backend}: the resumed step differs")
            print(f"g) {backend} backend: save, load into a fresh optimizer, "
                  f"one step each and one of the saved optimizer: "
                  f"parameters, state and history equal bit for bit")
        del loaded, fresh
    torch.backends.cudnn.deterministic = False
    return launches, peaks


def phase_data_path(data_dir):
    """13 a): a synthetic MNIST-shaped ``.npy`` dataset through the native
    loader and the device prefetcher, every batch held bitwise against the
    same loader seed read without the prefetcher; the pop against a
    blocking copy of the same batch."""
    xp, yp = mnist_npy(data_dir)
    t0 = time.perf_counter()
    _build.build("batcher.cpp")
    build_s = time.perf_counter() - t0

    depth, count = 2, 16  # 8 passes through the queue
    ref = runtime.PrefetchLoader.from_npy(xp, yp, 32, seed=0)
    loader = runtime.PrefetchLoader.from_npy(xp, yp, 32, seed=0)
    device = torch.device("cuda", torch.cuda.current_device())
    with runtime.DevicePrefetcher(loader, depth=depth, n_batches=count,
                                  close_source=True) as pf:
        got = 0
        for bx, by in pf:
            rx, ry = ref.next_batch()
            if not (bx.device == by.device == device
                    and by.dtype == torch.int64
                    and torch.equal(bx, torch.from_numpy(rx).to(device))
                    and torch.equal(by, torch.from_numpy(ry).to(device))):
                raise AssertionError(f"prefetched batch {got} differs")
            got += 1
    if got != count or loader._h is not None:
        raise AssertionError(f"{got} batches of {count}; handle {loader._h}")

    # the pop of a batch already on the card, and the blocking copy of it
    pops, copies = [], []
    with runtime.DevicePrefetcher(ref, depth=depth, n_batches=20) as pf:
        for _ in range(20):
            while pf._q.qsize() < depth and pf._thread.is_alive():
                time.sleep(0.001)  # the batch is on the card before the pop
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bx, _ = next(pf)
            torch.cuda.synchronize()
            pops.append((time.perf_counter() - t0) * 1e3)
            host = bx.cpu().numpy()
            t0 = time.perf_counter()
            torch.from_numpy(host).to(device)
            torch.cuda.synchronize()
            copies.append((time.perf_counter() - t0) * 1e3)
    ref.close()
    print(f"13 a) .npy [2048, 28, 28, 1] f32 + int64 labels -> PrefetchLoader "
          f"(g++ build {build_s:.2f} s) -> DevicePrefetcher(depth {depth}, "
          f"cuda): {count} batches of 32 bitwise equal to the loader read "
          f"without it, labels int64, on {device}; median host ms over 20: "
          f"queue pop {statistics.median(pops):.3f}, blocking .to('cuda') "
          f"of the same batch {statistics.median(copies):.3f}")


def mnist_npy(data_dir, write=False):
    """The paths of 13 a)'s synthetic MNIST-shaped ``.npy`` set in
    ``data_dir`` (``train_x.npy`` [2048, 28, 28, 1] in [0, 1],
    ``train_y.npy`` int64), written first when ``write``."""
    xp, yp = (os.path.join(data_dir, f) for f in ("train_x.npy",
                                                  "train_y.npy"))
    if write:
        rng = np.random.default_rng(0)
        np.save(xp, rng.random((2048, 28, 28, 1), dtype=np.float32))
        np.save(yp, rng.integers(0, 10, 2048).astype(np.int64))
    return xp, yp


def start_flagship():
    """Write 13 a)'s data set into a directory of its own and start 13 b)'s
    ``examples_torch/run_resnet18_mnist.py --data`` on it in a
    subprocess, its output in files there (:func:`stop_examples` stops it
    and removes the directory); returns ``(directory, handle)``."""
    data_dir = tempfile.mkdtemp(prefix="chip_smoke_mnist_")
    mnist_npy(data_dir, write=True)
    script = Path(__file__).resolve().parent / "examples_torch" / \
        "run_resnet18_mnist.py"
    files = [open(os.path.join(data_dir, f"example.{kind}"), "w+")
             for kind in ("out", "err")]
    proc = subprocess.Popen([sys.executable, str(script), "--data",
                             data_dir], stdout=files[0], stderr=files[1],
                            text=True)
    handle = (proc, files, time.perf_counter())
    _STARTED.append((data_dir, [handle]))
    return data_dir, handle


def phase_flagship_example(handle):
    """13 b): ``examples_torch/run_resnet18_mnist.py --data`` at full width
    in a subprocess started by :func:`start_flagship`; returns its kernel
    launches."""
    returncode, out, err, wall = wait_example(handle, timeout=600)
    if returncode != 0:
        raise AssertionError(f"run_resnet18_mnist.py exited "
                             f"{returncode}:\n{out}\n{err[-3000:]}")
    det = out.split("determinism self-test: ")[1].splitlines()[0]
    losses = [tuple(float(v) for v in line.split("loss ")[1].split(" |")[0]
                    .split(" -> "))
              for line in out.splitlines() if line.startswith("step ")]
    launches = int(out.split("fused_cg_update launches: ")[1].split()[0])
    iters = [int(i) for i in out.split("(CG iterations [")[1].split("]")[0]
             .split(",")]
    if not ("11,175,370" in out and "False" not in det and len(losses) == 2
            and all(math.isfinite(v) for pair in losses for v in pair)
            and losses[0][1] < losses[0][0] and launches == sum(iters)):
        raise AssertionError(f"run_resnet18_mnist.py:\n{out}")
    for line in out.splitlines():
        print(f"    | {line}")
    print(f"13 b) run_resnet18_mnist.py --data (started before phase 12): "
          f"exit 0, read {wall:.1f} s after its start; "
          f"determinism self-test {det}; losses {losses}; fused_cg_update "
          f"launches {launches} = CG iterations {iters}")
    return launches


def module_tree(flat, ravel, names):
    """A flat vector of the ``nn.Sequential`` All-CNN-C -> the functional
    model's tree (OIHW -> HWIO)."""
    d = ravel.unravel(flat)
    return {"convs": [{"w": d[f"{n}.weight"].permute(2, 3, 1, 0),
                       "b": d[f"{n}.bias"]} for n in names]}


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_module_path(acc_matvec_ms):
    """13 c): full-width All-CNN-C/CIFAR-100 as an ``nn.Sequential``
    through ``module_fns`` against the functional model, then 2 HF steps
    on the adapter; returns their kernel launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_allcnnc(gen, device="cuda")  # phase 8's weights
    net = load_hwio_convs(allcnnc_sequential().cuda(), params)
    names = [n for n, m in net.named_modules()
             if isinstance(m, torch.nn.Conv2d)]
    mparams, buffers = pkg.split_module_state(net)
    count = sum(t.numel() for t in mparams.values())
    if count != ALLCNNC_PARAMS or buffers:
        raise AssertionError(f"nn.Sequential All-CNN-C: {count} parameters")
    x = torch.randn((128, 32, 32, 3), generator=gen, device="cuda")
    y = torch.randint(0, 100, (128,), generator=gen, device="cuda")
    # the same memory viewed as NCHW (channels_last), as allcnnc_apply
    # views it, so that both models run the same cuDNN kernels: with a
    # contiguous NCHW copy and the padding inside nn.Conv2d, the f32 sums
    # over 128 x 32 x 32 positions in other orders put the gradient 2.2e-5
    # away (norm-wise)
    nchw = (x.permute(0, 3, 1, 2), y)
    fns = pkg.module_fns(net, models.cross_entropy_loss)
    config = dict(damping=1.0, cg_max_iter=50)
    opt = pkg.HessianFree(mparams, model_fn=fns.model_fn,
                          loss_outer=fns.loss_outer,
                          config=pkg.HFConfig(**config), pad_to_multiple=1024)
    ref = pkg.HessianFree(params, model_fn=models.allcnnc_apply,
                          loss_outer=models.cross_entropy_loss,
                          config=pkg.HFConfig(**config), pad_to_multiple=1024)
    built = []
    for o, batch in ((opt, nchw), (ref, (x, y))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built.append(optimizer._build_matvec_and_grad(
            o.fns, o.config, o.ravel, o.params, batch))
        torch.cuda.synchronize()
        built[-1] += ((time.perf_counter() - t0) * 1e3,)
    (m_loss, m_grad, m_mvp, m_build), (f_loss, f_grad, f_mvp, f_build) = built
    v = torch.randn(opt.ravel.dim, generator=gen, device="cuda")
    v_ref = ref.ravel.ravel(module_tree(v, opt.ravel, names))
    errs = (abs(float(m_loss) / float(f_loss) - 1),
            rel(ref.ravel.ravel(module_tree(m_grad, opt.ravel, names)),
                f_grad),
            rel(ref.ravel.ravel(module_tree(m_mvp(v), opt.ravel, names)),
                f_mvp(v_ref)))
    if not max(errs) <= 1e-5:
        raise AssertionError(f"nn.Module All-CNN-C vs allcnnc_apply: loss, "
                             f"gradient, matvec relative errors {errs}")
    m_ms = statistics.median(cuda_ms(lambda: m_mvp(v), 20))
    f_ms = statistics.median(cuda_ms(lambda: f_mvp(v_ref), 20))
    print(f"13 c) All-CNN-C/CIFAR-100 as nn.Sequential (ZeroPad2d before "
          f"each SAME conv; {count} parameters, phase 8's seed-0 weights) "
          f"through module_fns, batch 128 NCHW (channels_last), against "
          f"allcnnc_apply on the same batch NHWC: relative error loss "
          f"{errs[0]:.2e}, gradient {errs[1]:.2e}, GGN matvec {errs[2]:.2e} "
          f"(norm-wise, rtol 1e-5); build {m_build:.1f} vs {f_build:.1f} "
          f"ms; GGN matvec median over 20 (CUDA events) {m_ms:.2f} ms "
          f"(functional {f_ms:.2f} ms; phase 8's accumulated matvec over "
          f"2 x 64 {acc_matvec_ms:.2f} ms)")
    del built, m_mvp, f_mvp, ref
    return run_steps(opt, nchw, 1, "phase 13's nn.Module step")


def phase_sizing(store_peaks):
    """13 d): the solver-memory estimate for the ResNet-18 and All-CNN-C
    configurations, and against phase 12 f's measured step peaks.

    The f32 - bf16 difference is held against the requested bytes' peaks:
    the allocated bytes count the allocator's blocks, and a block keeps a
    remainder under 1 MiB beside its request instead of splitting it off,
    so either run's allocated peak can sit up to that much above what its
    tensors asked for."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    ravels = {
        "ResNet-18/MNIST": pkg.TrainableRavel(
            models.init_resnet18(gen, device="cuda"), pad_to_multiple=1024),
        "All-CNN-C/CIFAR-100": pkg.TrainableRavel(
            models.init_allcnnc(gen, device="cuda"), pad_to_multiple=1024),
    }
    for name, ravel in ravels.items():
        text = format_solver_memory(ravel, pkg.HFConfig(cg_max_iter=50))
        print(f"13 d) solver memory, {name}, cg_max_iter=50: "
              + "; ".join(text.splitlines()))
    est = {store: solver_memory_bytes(ravels["ResNet-18/MNIST"], pkg.HFConfig(
        damping=1.0, cg_max_iter=50, cg=pkg.CGConfig(store_dtype=store)))
        for store in (None, "bfloat16")}
    est_diff = est[None]["total"] - est["bfloat16"]["total"]
    allocated, requested = store_peaks["allocated"], store_peaks["requested"]
    req_diff = requested[None] - requested["bfloat16"]
    alloc_diff = allocated[None] - allocated["bfloat16"]
    if not (abs(est_diff - req_diff) <= 2**20
            and all(est[s]["total"] <= allocated[s] for s in est)):
        raise AssertionError(f"estimate {est} against peaks {store_peaks}")
    print(f"13 d) ResNet-18 step (phase 12 f) f32 - bf16 iterate store: "
          f"estimate {est_diff} bytes; measured requested {req_diff} bytes "
          f"({abs(est_diff - req_diff)} apart, within 1 MiB), allocated "
          f"{alloc_diff} bytes ({abs(est_diff - alloc_diff)} apart); estimate "
          f"totals {gib(est[None]['total']):.3f} / "
          f"{gib(est['bfloat16']['total']):.3f} GiB <= measured allocated "
          f"step peaks {gib(allocated[None]):.3f} / "
          f"{gib(allocated['bfloat16']):.3f} GiB above the baseline")


def phase_front_door(acc_matvec_ms, store_peaks):
    """Phase 13: the data path, the flagship example, the ``nn.Module``
    path and the sizing (see the module docstring); returns the kernel
    launches of b) and c)."""
    data_dir, handle = EARLY.pop("13 b", None) or start_flagship()
    phase_data_path(data_dir)
    launches = phase_flagship_example(handle)
    launches += phase_module_path(acc_matvec_ms)
    phase_sizing(store_peaks)
    return launches

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_ms(fn, calls):
    """Per-call host-clock times (ms) of ``fn``, each ended by a device
    synchronization (gloo's collectives on CUDA tensors wait on the host,
    which CUDA events would not see)."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def digest(t):
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


_RESNET_REF = []


def resnet_reference(opt, batch):
    """``hf_step`` of phase 6's ResNet-18 from its seed-0 start with
    ``cudnn.deterministic`` on, the reference of 14 a and 15 a; taken once
    and kept for the other."""
    if not _RESNET_REF:
        _RESNET_REF.append(optimizer.hf_step(
            opt.params, opt.state, batch, fns=opt.fns, config=opt.config,
            ravel=opt.ravel))
    return _RESNET_REF[0]


def phase_dp_nccl():
    """14 a): NCCL on a 1-rank group; one DP step against ``hf_step``, bit
    for bit; the NCCL all_reduce time.  Returns the DP step's launches."""
    import torch.distributed as dist

    pdist.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                 backend="nccl", device="cuda:0")
    mesh = pmesh.make_mesh()
    opt, batch, _ = resnet_main_path()
    ravel = opt.ravel
    ref = resnet_reference(opt, batch)
    step = dp.make_dp_hf_step(opt.fns, opt.config, ravel, mesh)
    ops.fused_cg_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step(opt.params, opt.state, pmesh.shard_batch(batch, mesh))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.fused_cg_update.launches
    (rp, rs, rst), (gp, gs, gst) = ref, got
    same = (torch.equal(ravel.ravel(rp), ravel.ravel(gp))
            and all(torch.equal(a, b) for a, b in zip(rs, gs))
            and rst.num_cg_iters == gst.num_cg_iters
            and torch.equal(rst.init_loss, gst.init_loss)
            and torch.equal(rst.final_loss, gst.final_loss))
    if not same:
        raise AssertionError(
            f"1-rank NCCL DP step differs from hf_step: cg "
            f"{gst.num_cg_iters} vs {rst.num_cg_iters}, losses "
            f"{float(gst.init_loss)} -> {float(gst.final_loss)} vs "
            f"{float(rst.init_loss)} -> {float(rst.final_loss)}")
    if launches != gst.num_cg_iters:
        raise AssertionError(f"{launches} launches for {gst.num_cg_iters} "
                             f"CG iterations")
    v = torch.ones(MAIN_N, device="cuda")
    times = cuda_ms(lambda: dist.all_reduce(v, group=mesh.get_group("data")),
                    25)
    print(f"14 a) NCCL, 1-rank group, make_mesh() {mesh}: make_dp_hf_step on "
          f"ResNet-18/MNIST b32 from the seed-0 start equals hf_step bit for "
          f"bit (parameters, state, {gst.num_cg_iters} CG iterations, losses "
          f"{float(gst.init_loss):.6f} -> {float(gst.final_loss):.6f}); DP "
          f"step {ms:.1f} ms; NCCL all_reduce of [{MAIN_N}] f32: median "
          f"{statistics.median(times):.4f} ms over 25 (CUDA events); "
          f"fused_cg_update launches {launches} = CG iterations")
    dist.destroy_process_group()
    pdist._device = None
    return launches


def dp_rank(rank, world, port, out_path):
    """One rank of 14 b) and c) (``chip_smoke.py --dp-rank``): gloo on the
    card; writes its record to ``out_path``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    pdist.initialize_distributed(f"localhost:{port}", world, rank,
                                 backend="gloo", device="cuda:0")
    mesh = pmesh.make_mesh()
    rec = {"rank": rank}

    # b) ResNet-18/MNIST b32 as two shards of 16
    opt, batch, _ = resnet_main_path()
    ravel, fns, config = opt.ravel, opt.fns, opt.config
    local = pmesh.shard_batch(batch, mesh)
    v = torch.randn(ravel.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    with precision_ctx(config):
        # the shard_map names' semantics: each rank's rows alone
        loss, grad, mvp = optimizer._build_matvec_and_grad(
            fns, config, ravel, opt.params, local,
            dp._Reduce(mesh, "data", "mean"))
        mv = mvp(v)
        if rank == 0:
            # one process, the same two shards as chunks: BatchNorm
            # normalizes each shard by its own statistics, on the ranks as
            # in the accumulated step
            x, y = batch
            halves = [(x[:16], y[:16]), (x[16:], y[16:])]
            r_loss = accumulate.acc_loss(fns, opt.params, halves, "mean")
            r_grad = accumulate.acc_grad(fns, opt.params, halves, "mean",
                                         ravel)
            r_mv = accumulate.make_acc_mvp(fns, config, opt.params, halves,
                                           "mean", ravel)(v)
            rec["b_rel"] = [abs(float(loss) / float(r_loss) - 1),
                            rel(grad, r_grad), rel(mv, r_mv)]
            # and the whole batch of 32, whose statistics no rank sees
            w_loss, w_grad = value_and_grad(
                lambda p: fns.full_loss(p, batch), opt.params)
            w_mv = ravel.ravel(ggnvp(
                lambda p: fns.model_fn(p, x),
                lambda o: fns.loss_outer(o, y), opt.params,
                ravel.unravel(v)))
            rec["b_whole"] = [abs(float(loss) / float(w_loss) - 1),
                              rel(grad, ravel.ravel(w_grad)), rel(mv, w_mv)]
            del r_grad, r_mv, w_grad, w_mv
    del grad, mvp, mv
    step = dp.make_dp_hf_step(fns, config, ravel, mesh)
    params, state = opt.params, opt.state
    ops.fused_cg_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, st = step(params, state, local)
    torch.cuda.synchronize()
    rec["b_steps"] = [{
        "ms": (time.perf_counter() - t0) * 1e3,
        "iters": st.num_cg_iters, "init": float(st.init_loss),
        "final": float(st.final_loss), "params": digest(ravel.ravel(
            params))}]
    rec["b_launches"] = ops.fused_cg_update.launches
    u = torch.ones(MAIN_N, device="cuda")
    rec["gloo_ms"] = statistics.median(host_ms(
        lambda: dist.all_reduce(u, group=mesh.get_group("data")), 10))
    del opt, params, state, local, batch, u

    # c) phase 8's All-CNN-C/CIFAR-100, each chunk split 32/32
    gen = torch.Generator(device="cuda").manual_seed(0)
    aparams = models.init_allcnnc(gen, device="cuda")
    x = torch.randn((256, 32, 32, 3), generator=gen, device="cuda")
    y = torch.randint(0, 100, (256,), generator=gen, device="cuda")
    aopt = allcnnc_opt(aparams, damping=1.0, cg_max_iter=50)
    ravel, fns, config = aopt.ravel, aopt.fns, aopt.config
    chunks = (x.reshape(4, 64, 32, 32, 3), y.reshape(4, 64))
    split = pmesh.Sharding(mesh, "data", dim=1)
    local_chunks = tuple(split.take(t).contiguous() for t in chunks)
    xl, yl = pmesh.shard_batch((x, y), mesh)
    with precision_ctx(config):
        diag = dp.dp_diag_EF(fns, aparams, xl, yl, "mean", ravel, mesh)
        mvp = optimizer._acc_parts(
            fns, config, ravel, aparams, local_chunks, local_chunks,
            local_chunks, "mean", reduce=dp._Reduce(mesh, "data", "mean"))[2]
        v = torch.randn(ravel.dim, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(4))
        mv = mvp(v)
        if rank == 0:
            r_diag = pkg.diag_EF(fns.model_fn, fns.loss_outer, aparams, x, y,
                                 "mean", ravel, loss_reg=fns.loss_reg)
            r_mvp = accumulate.make_acc_mvp(fns, config, aparams, chunks,
                                            "mean", ravel)
            rec["c_rel"] = [rel(diag, r_diag), rel(mv, r_mvp(v))]
            del r_diag, r_mvp
    precond = pkg.EMADiag(0.9).update(diag)
    ops.fused_cg_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, _, st = dp.make_dp_hf_acc_step(fns, config, ravel, mesh)(
        aparams, aopt.state, local_chunks, precond_diag=precond)
    torch.cuda.synchronize()
    rec["c_step"] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "iters": st.num_cg_iters, "init": float(st.init_loss),
                     "final": float(st.final_loss),
                     "params": digest(ravel.ravel(p))}
    rec["c_launches"] = ops.fused_cg_update.launches
    with open(out_path, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"rank {rank}/{world}: ok")


def check_losses(label, steps):
    for s in steps:
        if not (math.isfinite(s["init"]) and math.isfinite(s["final"])
                and s["final"] <= s["init"]):
            raise AssertionError(f"{label}: losses {steps}")


def phase_dp_two_ranks():
    """14 b) and c): two gloo ranks sharing the card; returns the launches
    of both ranks' steps."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             "2", str(port), paths[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=400)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"rank {r}/2: ok" not in out:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                     f"{out[-4000:]}")
        r0, r1 = (json.load(open(path)) for path in paths)
    launches = 0
    for rec in (r0, r1):
        check_losses("14 b)", rec["b_steps"])
        check_losses("14 c)", [rec["c_step"]])
        iters_b = sum(s["iters"] for s in rec["b_steps"])
        if (rec["b_launches"] != iters_b
                or rec["c_launches"] != rec["c_step"]["iters"]):
            raise AssertionError(f"rank {rec['rank']}: launches "
                                 f"{rec['b_launches']}, {rec['c_launches']}")
        launches += rec["b_launches"] + rec["c_launches"]
    for key in ("iters", "params"):
        if ([s[key] for s in r0["b_steps"]] != [s[key] for s in r1["b_steps"]]
                or r0["c_step"][key] != r1["c_step"][key]):
            raise AssertionError(f"the ranks' {key} differ: {r0} vs {r1}")
    if not max(r0["b_rel"] + r0["c_rel"]) <= 1e-5:
        raise AssertionError(f"reduced values: b {r0['b_rel']}, c "
                             f"{r0['c_rel']}")
    steps = r0["b_steps"]
    print(f"14 b) two gloo ranks sharing the card (subprocesses, {wall:.1f} s "
          f"with start-up), ResNet-18/MNIST b32 as 2 x 16: reduced loss, "
          f"gradient, GGN matvec with each rank's BatchNorm statistics its "
          f"own rows' (the shard_map names) vs one process on the same two "
          f"shards as chunks, relative {r0['b_rel'][0]:.2e}, "
          f"{r0['b_rel'][1]:.2e}, {r0['b_rel'][2]:.2e} (norm-wise, <= "
          f"1e-5), and vs one process on the whole batch of 32 "
          f"{r0['b_whole'][0]:.2e}, {r0['b_whole'][1]:.2e}, "
          f"{r0['b_whole'][2]:.2e} (no bound; 15 e has the GSPMD names'); "
          f"1 make_dp_hf_step step (BatchNorm over both ranks' rows): "
          f"losses "
          f"{[(round(s['init'], 6), round(s['final'], 6)) for s in steps]}, "
          f"CG iterations {[s['iters'] for s in steps]} on both ranks, "
          f"parameters bitwise equal on both; step ms (two "
          f"ranks sharing one card, not a scaling figure) "
          f"{[round(s['ms'], 1) for s in steps]} (rank 0), "
          f"{[round(s['ms'], 1) for s in r1['b_steps']]} (rank 1); gloo "
          f"all_reduce of [{MAIN_N}] f32 on the card: median "
          f"{r0['gloo_ms']:.2f} / {r1['gloo_ms']:.2f} ms over 10 (host "
          f"clock, ranks 0 / 1)")
    c = r0["c_step"]
    print(f"14 c) same ranks, All-CNN-C/CIFAR-100 b256 as 4 chunks of 64, "
          f"each split 32/32, CE + L2: dp_diag_EF vs diag_EF on the whole "
          f"batch {r0['c_rel'][0]:.2e}, accumulated GGN matvec vs one "
          f"process {r0['c_rel'][1]:.2e} (norm-wise, <= 1e-5); one "
          f"make_dp_hf_acc_step step with the EMA diagonal: loss "
          f"{c['init']:.6f} -> {c['final']:.6f}, {c['iters']} CG iterations, "
          f"{c['ms']:.1f} ms (rank 0), parameters bitwise equal on both "
          f"ranks; fused_cg_update launches: rank 0 "
          f"{r0['b_launches']} + {r0['c_launches']}, rank 1 "
          f"{r1['b_launches']} + {r1['c_launches']} = their CG iterations")
    return launches


def start_example(tmp, script, flags, nproc):
    """Start ``examples_torch/script`` under ``torch.distributed.run`` with
    ``nproc`` gloo ranks on the card, its output going to files in ``tmp``
    (no full pipe can stall it); returns the handle :func:`wait_example`
    takes."""
    examples = Path(__file__).resolve().parent / "examples_torch"
    name = "".join([script, *flags])
    files = [open(os.path.join(tmp, f"{name}.{kind}"), "w+")
             for kind in ("out", "err")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), script, *flags, "--backend",
         "gloo"],
        cwd=examples, stdout=files[0], stderr=files[1], text=True)
    return proc, files, time.perf_counter()


_STARTED = []  # (output directory, handles) of every example started
EARLY = {}  # examples started ahead of the phase that checks them


def start_examples(runs):
    """Start the examples ``[(script, flags, nproc)]`` at once, their output
    in a directory of their own; :func:`stop_examples` stops them."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    handles = [start_example(tmp, script, flags, nproc)
               for script, flags, nproc in runs]
    _STARTED.append((tmp, handles))
    return handles


def stop_examples():
    """Kill every started example still running and remove its output."""
    for tmp, handles in _STARTED:
        for proc, files, _ in handles:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in files:
                f.close()
        shutil.rmtree(tmp, ignore_errors=True)
    _STARTED.clear()


def model_axis_examples():
    """Start 15 f's examples: beside the single-process phases 12 and 13
    in the whole script, where the host has cores to spare."""
    return start_examples([(script, flags, 2)
                           for script, flags, _ in MODEL_AXIS_EXAMPLES])


def wait_example(handle, timeout=400):
    """``(returncode, stdout, stderr, seconds from its start to now)`` of a
    started example (an upper bound on its run time, since it is read once
    the work beside it ends); it is killed if it outlasts ``timeout``."""
    proc, files, t0 = handle
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        texts = []
        for f in files:
            f.seek(0)
            texts.append(f.read())
            f.close()
    return proc.returncode, texts[0], texts[1], time.perf_counter() - t0


def example_launches(label, out, nproc):
    """The kernel launches that an example's ranks report on rank 0's
    output (``report_launches``), each checked against its CG
    iterations; their sum."""
    launches = 0
    for r in range(nproc):
        line = out.split(f"rank {r}: fused_cg_update launches: ")[1]
        n = int(line.split()[0])
        iters = [int(i) for i in line.split("(CG iterations [")[1]
                 .split("]")[0].split(",")]
        if n != sum(iters):
            raise AssertionError(f"{label} rank {r}: {n} launches for "
                                 f"{iters}")
        launches += n
    return launches


def check_dp_example(handle):
    """14 d): the --dp example, started before 14 a; returns both ranks'
    launches."""
    returncode, out, err, wall = wait_example(handle)
    if returncode != 0:
        raise AssertionError(f"the --dp example exited {returncode}:\n"
                             f"{out}\n{err[-4000:]}")
    losses = [tuple(float(v) for v in line.split("loss ")[1].split(" |")[0]
                    .split(" -> "))
              for line in out.splitlines() if line.startswith("step ")]
    launches = example_launches("the --dp example", out, 2)
    if not ("2 data-parallel ranks" in out and len(losses) == 2
            and all(math.isfinite(v) for pair in losses for v in pair)):
        raise AssertionError(f"the --dp example:\n{out}")
    for line in out.splitlines():
        print(f"    | {line}")
    print(f"14 d) run_allcnnc_cifar100.py --dp --backend gloo under "
          f"torch.distributed.run --nproc-per-node 2 on the card (started "
          f"before 14 a): exit 0, read {wall:.1f} s after its start; losses "
          f"{losses}; launches {launches} = both ranks' CG iterations")
    return launches


def megatron_decoder_specs(n_layers):
    """tests/test_sharded.py:316-331's Megatron tree for the decoder LM:
    QKV and FF1 by column, proj and FF2 by row, the embeddings by feature
    (the step partitions the blocks' compute, the embeddings' lookup and
    the tied head's contraction; ``ln_f`` replicated)."""
    P = pmesh.PartitionSpec
    col, row = P(None, "model"), P("model", None)
    return {"embed": P(None, "model"), "pos": P(None, "model"), "ln_f": P(),
            "blocks": [{"ln1": P(), "ln2": P(),
                        "qkv": {"w": col, "b": P("model")},
                        "proj": {"w": row, "b": P()},
                        "ff1": {"w": col, "b": P("model")},
                        "ff2": {"w": row, "b": P()}}
                       for _ in range(n_layers)]}


def whole_params(params, specs, mesh, ravel):
    """A sharded step's parameters (its sharded leaves this rank's blocks)
    -> the whole flat vector, on every rank."""
    return ravel.ravel(sharded.unshard_params(params, specs, mesh, ravel))


def same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_shard_nccl():
    """15 a): NCCL on a 1-rank (data 1, model 1) mesh; one
    ``make_sharded_hf_step`` step against ``hf_step``, bit for bit.
    Returns the sharded step's launches."""
    import torch.distributed as dist

    pdist.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                 backend="nccl", device="cuda:0")
    mesh = pmesh.make_mesh(axis_names=("data", "model"), shape=(1, 1))
    opt, batch, _ = resnet_main_path()
    ravel = opt.ravel
    ref = resnet_reference(opt, batch)
    step = sharded.make_sharded_hf_step(opt.fns, opt.config, ravel, mesh)
    ops.fused_cg_update.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = step(opt.params, opt.state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = ops.fused_cg_update.launches
    (rp, rs, rst), (gp, gs, gst) = ref, got
    if not (torch.equal(ravel.ravel(rp), ravel.ravel(gp))
            and same_state(rs, gs) and rst.num_cg_iters == gst.num_cg_iters
            and torch.equal(rst.init_loss, gst.init_loss)
            and torch.equal(rst.final_loss, gst.final_loss)):
        raise AssertionError(
            f"1-rank sharded step differs from hf_step: cg "
            f"{gst.num_cg_iters} vs {rst.num_cg_iters}, losses "
            f"{float(gst.init_loss)} -> {float(gst.final_loss)} vs "
            f"{float(rst.init_loss)} -> {float(rst.final_loss)}")
    if launches != gst.num_cg_iters:
        raise AssertionError(f"{launches} launches for {gst.num_cg_iters} "
                             f"CG iterations")
    print(f"15 a) NCCL, 1-rank (data 1, model 1) mesh: make_sharded_hf_step "
          f"on ResNet-18/MNIST b32 from the seed-0 start equals hf_step bit "
          f"for bit (parameters, state, {gst.num_cg_iters} CG iterations, "
          f"losses {float(gst.init_loss):.6f} -> "
          f"{float(gst.final_loss):.6f}); step {ms:.1f} ms; fused_cg_update "
          f"launches {launches} = CG iterations")
    dist.destroy_process_group()
    pdist._device = None
    return launches


def timed_steps(step, params, state, batch, count, ravel, whole=None):
    """``count`` steps with their host-clock ms, CG iterations, losses;
    returns ``(params, state, records, whole flat parameters per step)``."""
    records, flats = [], []
    for _ in range(count):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, st = step(params, state, batch)
        torch.cuda.synchronize()
        records.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "iters": st.num_cg_iters,
                        "init": float(st.init_loss),
                        "final": float(st.final_loss)})
        flats.append(ravel.ravel(params) if whole is None else whole(params))
        records[-1]["params"] = digest(flats[-1])
    return params, state, records, flats


CG_CHECK_ITERS = 10


def fixed_cg(A, b, **kwargs):
    """CG for exactly :data:`CG_CHECK_ITERS` iterations (no Martens stop,
    no tolerance): the sharded solver's arithmetic against one process's,
    with no stopping decision that a last-bit difference could flip."""
    return pkg.cg(A, b, max_iter=CG_CHECK_ITERS, tol=0.0,
                  store_x_at_iters=(), **kwargs)


def sharded_cg(shard, mvp, grad, damping):
    """:func:`fixed_cg` of the damped system ``mvp + damping`` on this
    rank's blocks (``mvp`` and ``grad`` the rank's, as a sharded step's);
    returns the whole iterate and the m-history."""
    res = fixed_cg(lambda v: mvp(v) + damping * v, -grad, shard_vec=shard,
                   shard_buf=shard)
    return shard.gather(res.x), res.m_hist


def gloo_bytes(fn):
    """``(fn(), bytes)``: what this rank hands to the collectives inside
    ``fn``, by op: all-reduce buffers and all-to-all sends."""
    import torch.distributed as dist

    counts = {"all_reduce": 0, "all_to_all": 0, "all_reduce_calls": 0,
              "all_to_all_calls": 0}
    reduce, a2a = dist.all_reduce, dist.all_to_all_single

    def all_reduce(t, *args, **kwargs):
        counts["all_reduce"] += t.numel() * t.element_size()
        counts["all_reduce_calls"] += 1
        return reduce(t, *args, **kwargs)

    def all_to_all_single(out, inp, *args, **kwargs):
        counts["all_to_all"] += inp.numel() * inp.element_size()
        counts["all_to_all_calls"] += 1
        return a2a(out, inp, *args, **kwargs)

    dist.all_reduce, dist.all_to_all_single = all_reduce, all_to_all_single
    try:
        return fn(), counts
    finally:
        dist.all_reduce, dist.all_to_all_single = reduce, a2a


def local_tree(local, whole, specs, partitioned):
    """A step's local tree against the whole one: its entries and bytes,
    its largest leaf's shape, and whether a leaf whose spec
    ``partitioned(spec)`` names reaches the forward whole."""
    leaves, full = tree_flatten(local)[0], tree_flatten(whole)[0]
    per_leaf = sharded._spec_leaves(sharded._param_shardings(None, whole,
                                                             specs))
    return {"entries": sum(t.numel() for t in leaves),
            "bytes": sum(t.numel() * t.element_size() for t in leaves),
            "largest": list(max(leaves, key=lambda t: t.numel()).shape),
            "whole_block_leaf": any(
                partitioned(spec) and t.shape == w.shape
                for t, w, spec in zip(leaves, full, per_leaf))}


def tensor_split(spec):
    """A leaf that the Megatron program partitions: its spec splits it."""
    return any(part is not None for part in spec or ())


def expert_split(spec):
    """A leaf that expert parallelism partitions: an ExpertSpec's."""
    return isinstance(spec, pmesh.ExpertSpec)


def spec_blocks(params, specs, mesh):
    """This rank's blocks of the leaves that ``specs`` shards (the others
    whole), as a sharded step keeps them between steps."""
    leaves, treedef = tree_flatten(params)
    per_leaf = sharded._spec_leaves(
        sharded._param_shardings(mesh, params, specs))
    return tree_unflatten(treedef, [
        leaf if spec is None else pmesh.shard_leaf(leaf, spec, mesh)
        for leaf, spec in zip(leaves, per_leaf)])


def shard_resnet(mesh, rank, rec):
    """15 b) on one rank: 1 sharded ResNet-18 step, its peak, the
    collectives of a CG iteration, and a fixed-length CG solve of the
    step's damped system on the rank's blocks; rank 0 then runs one
    process's ``hf_step`` and the same solve, and compares."""
    import torch.distributed as dist

    opt, batch, _ = resnet_main_path()
    ravel, fns, config = opt.ravel, opt.fns, opt.config
    step = sharded.make_sharded_hf_step(fns, config, ravel, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    base = requested_bytes("current")
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cg_update.launches = 0
    _, state, rec["b_steps"], flats = timed_steps(
        step, opt.params, opt.state, batch, 1, ravel)
    rec["b_launches"] = ops.fused_cg_update.launches
    rec["b_peak"] = requested_bytes("peak") - base
    rec["b_block"] = state.x0.numel()
    # a matvec's transfers in the step: the direction laid out to the
    # local tree (every leaf whole here: an all-gather by all-to-all) and
    # the product back to the rank's block (its own entries)
    layout = sharded._Plan(fns, config, ravel, mesh, "data", "model", None,
                           None, "mean", stacked=False).enter(
                               opt.params, batch).ravel
    shard = sharded.ModelShard(pmesh.model_axis(mesh), ravel.dim)
    blk = torch.randn(shard.block, device="cuda")
    tree = layout.unravel(blk)
    rec["gather_ms"] = statistics.median(host_ms(
        lambda: layout.unravel(blk), 10))
    rec["ravel_ms"] = statistics.median(host_ms(
        lambda: layout.ravel(tree), 10))
    rec["dot_ms"] = statistics.median(host_ms(lambda: shard.dot(blk, blk),
                                              20))
    del step, state, blk, tree, layout
    with precision_ctx(config):
        _, grad, mvp = optimizer._build_matvec_and_grad(
            fns, config, ravel, opt.params, batch)
        x_sharded, m_sharded = sharded_cg(
            shard, lambda u: shard(mvp(shard.gather(u))), shard(grad),
            config.damping)
    dist.barrier()
    if rank == 0:
        with precision_ctx(config):
            one_cg = fixed_cg(lambda v: mvp(v) + config.damping * v, -grad)
        rec["cg_rel"] = [rel(x_sharded, one_cg.x),
                         rel(m_sharded, one_cg.m_hist)]
        del grad, mvp, one_cg
        gc.collect()
        torch.cuda.empty_cache()
        base = requested_bytes("current")
        torch.cuda.reset_peak_memory_stats()
        one = functools.partial(optimizer.hf_step, fns=fns, config=config,
                                ravel=ravel)
        _, _, rec["b_ref_steps"], ref = timed_steps(
            one, opt.params, opt.state, batch, 1, ravel)
        rec["b_ref_peak"] = requested_bytes("peak") - base
        rec["b_rel"] = [rel(a, b) for a, b in zip(flats, ref)]
        rec["b_loss_rel"] = [abs(a["final"] / b["final"] - 1)
                             for a, b in zip(rec["b_steps"],
                                             rec["b_ref_steps"])]
        mem = [solver_memory_bytes(ravel, config, m) for m in (1, 2)]
        rec["b_est"] = [mem[0]["total"], mem[1]["per_device"]]


def decoder_problem(n_layers=LM["n_layers"]):
    """Phase 10's full-width decoder LM from the seed-0 start, its blocks in
    sequence, of ``n_layers`` blocks: ``(params, batch, fns, config,
    ravel)``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_decoder_lm(gen, max_len=128,
                                    **dict(LM, n_layers=n_layers))
    tokens = affine_tokens(gen, 32, 128, LM["vocab"], "cuda")
    fns = pkg.HFModelFns(
        model_fn=functools.partial(models.decoder_lm_apply,
                                   n_heads=LM["n_heads"]),
        loss_outer=models.next_token_loss)
    config = pkg.HFConfig(damping=1.0, cg_max_iter=50)
    ravel = pkg.TrainableRavel(params, pad_to_multiple=1024)
    return params, (tokens, tokens), fns, config, ravel


def megatron_values(fns, config, ravel, mesh, params, specs, batch, v):
    """What the sharded step computes with under the Megatron ``specs``
    (the rows replicated; ``sharded._Plan.enter``: the local tree of this
    rank's blocks, the forward's axes, the layout) and one gradient +
    build + GGN matvec on it: ``(entry, shard, (loss, grad, mvp, mvp(v)),
    peak of requested bytes)``, the gradient and product this rank's
    blocks."""
    plan = sharded._Plan(fns, config, ravel, mesh, "data", "model", specs,
                         pmesh.PartitionSpec(), "mean", stacked=False)
    e = plan.enter(spec_blocks(params, specs, mesh), batch)
    vb = plan.shard(v)

    def build():
        with collectives.axes(**e.axes), precision_ctx(config):
            loss, grad, mvp = optimizer._build_matvec_and_grad(
                e.fns, config, e.ravel, e.params, e.batch, e.reduce)
            return loss, grad, mvp, mvp(vb)

    out, _, _, peak = with_peak(build)
    return e, plan.shard, out, peak


def forward_flops(fns, params, tokens, axes=None):
    """One forward under ``axes``: its FLOPs (``FlopCounterMode``: the
    matmuls) and the gathers and sums over an axis that it calls
    (``gather_from_axis``, ``reduce_from_axis``)."""
    from torch.utils.flop_counter import FlopCounterMode

    names = ("gather_from_axis", "reduce_from_axis")
    calls = dict.fromkeys(names, 0)
    originals = {name: getattr(collectives, name) for name in names}

    def counted(name):
        def call(x, axis, *args):
            calls[name] += axis is not None
            return originals[name](x, axis, *args)
        return call

    for name in names:
        setattr(collectives, name, counted(name))
    try:
        with torch.no_grad(), collectives.axes(**(axes or {})), \
                FlopCounterMode(display=False) as counter:
            fns.model_fn(params, tokens)
    finally:
        for name in names:
            setattr(collectives, name, originals[name])
    return (counter.get_total_flops(), calls["gather_from_axis"],
            calls["reduce_from_axis"])


def values_and_peak(fns, config, ravel, params, batch, v, axes=None):
    """One gradient + build + GGN matvec under ``axes`` (``None``: the
    whole forward): ``((loss, grad, mvp, mvp(v)), peak of requested
    bytes)``."""
    def build():
        with collectives.axes(**(axes or {})), precision_ctx(config):
            loss, grad, mvp = optimizer._build_matvec_and_grad(
                fns, config, ravel, params, batch)
            return loss, grad, mvp, mvp(v)

    out, _, _, peak = with_peak(build)
    return out, peak


def hessian_matvec(fns, params, tokens, ravel, v, axes=None):
    """One-shot Hessian matvec (forward over reverse) under ``axes``."""
    with collectives.axes(**(axes or {})):
        return ravel.ravel(hvp(
            lambda p: fns.loss_outer(fns.model_fn(p, tokens), tokens),
            params, ravel.unravel(v)))


def shard_decoder(mesh, rank, rec):
    """15 c) on one rank: the full-width decoder LM.  Context parallel: the
    loss, gradient and one GGN matvec, a fixed-length CG solve of the
    start's system on the ranks' blocks, 1 step.  Megatron (the Megatron
    specs' blocks, gathered as the step gathers them, through the
    partitioned forward): the forward's FLOPs, the loss, gradient, GGN and
    Hessian matvecs, the peak of one gradient + build + matvec beside the
    replicated-weights one, the gloo ms of a matvec, the same solve and 1
    step.  Rank 0 then computes one process's values, FLOPs, peak, solve
    and step."""
    import torch.distributed as dist

    params, batch, fns, config, ravel = decoder_problem()
    tokens = batch[0]
    state = pkg.init_state(ravel, config)
    P = pmesh.PartitionSpec
    axis = pmesh.model_axis(mesh)
    v = torch.randn(ravel.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    shard = sharded.ModelShard(axis, ravel.dim)
    specs = megatron_decoder_specs(LM["n_layers"])
    # CP beside the Megatron specs (15 g): the plan computes the blocks
    # gathered, so these are the CP forward's values
    t_g = time.perf_counter()
    cp, mvp, cp_e, _ = plan_values(fns, ravel, mesh, params, batch, v,
                                   param_specs=specs,
                                   batch_specs=P(None, "model"))
    rec["g_time"] += time.perf_counter() - t_g
    rec["g_mega_cp_roles"] = roles(cp_e.axes)
    rec["g_mega_cp_grad"] = digest(cp[1])
    with collectives.axes(**cp_e.axes), precision_ctx(config):
        solves = {"cp_cg": sharded_cg(shard, mvp, shard(cp[1]),
                                      config.damping)}
    del mvp
    # Megatron: the step's local tree (this rank's blocks), its forward
    tp_e, _, (tp_loss, tp_grad, tp_mvp, tp_mv), rec["tp_peak"] = \
        megatron_values(fns, config, ravel, mesh, params, specs, batch, v)
    rec["tp_local"] = local_tree(tp_e.params, params, specs, tensor_split)
    rec["tp_roles"] = roles(tp_e.axes) + sorted(tp_e.axes["tensor_leaves"])
    rec["tp_flops"], rec["tp_gathers"], rec["tp_sums"] = forward_flops(
        fns, tp_e.params, tokens, tp_e.axes)
    rec["tp_grad"] = digest(shard.gather(tp_grad))
    vb = shard(v)
    with collectives.axes(**tp_e.axes), precision_ctx(config):
        solves["tp_cg"] = sharded_cg(shard, tp_mvp, tp_grad, config.damping)
        _, rec["tp_mv_bytes"] = gloo_bytes(lambda: tp_mvp(vb))
        rec["tp_mv_ms"] = statistics.median(host_ms(lambda: tp_mvp(vb), 5))
    del tp_mvp
    # the gloo ms of the collectives that the embeddings' and the head's
    # partition adds to a pass: the sum of the partial [32, 128, V]
    # logits, and the gather of the [32, 128, d / 2] stream blocks
    logits = torch.randn(32, 128, LM["vocab"], device="cuda")
    stream = torch.randn(32, 128, LM["d_model"] // 2, device="cuda")
    rec["tp_logits_sum_ms"] = statistics.median(
        host_ms(lambda: collectives._reduce(logits, axis), 5))
    rec["tp_stream_gather_ms"] = statistics.median(
        host_ms(lambda: collectives._gather(stream, axis, 2), 5))
    del logits, stream
    with precision_ctx(config):
        tp = [tp_loss, shard.gather(tp_grad), shard.gather(tp_mv),
              shard.gather(hessian_matvec(tp_e.fns, tp_e.params, tokens,
                                          tp_e.ravel, vb, tp_e.axes))]
    del tp_e, tp_grad, tp_mv
    _, rec["plain_peak"] = values_and_peak(fns, config, ravel, params, batch,
                                           v)
    t_g = time.perf_counter()
    ema = joined_decoder(fns, config, ravel, mesh, batch, cp_e, rec)
    rec["g_time"] += time.perf_counter() - t_g
    # the steps on the first STEP_LAYERS blocks (the values above: all)
    layers = STEP_LAYERS["decoder LM"]
    s_params, s_batch, _, _, s_ravel = decoder_problem(layers)
    s_state = pkg.init_state(s_ravel, config)
    s_specs = megatron_decoder_specs(layers)
    cp_step = sharded.make_sharded_hf_step(fns, config, s_ravel, mesh,
                                           batch_specs=P(None, "model"))
    ops.fused_cg_update.launches = 0
    _, _, rec["cp_steps"], cp_flats = timed_steps(
        cp_step, s_params, s_state, s_batch, 1, s_ravel)
    rec["cp_launches"] = ops.fused_cg_update.launches
    tp_step = sharded.make_sharded_hf_step(fns, config, s_ravel, mesh,
                                           param_specs=s_specs)
    ops.fused_cg_update.launches = 0
    tp_params, _, rec["tp_steps"], tp_flats = timed_steps(
        tp_step, s_params, s_state, s_batch, 1, s_ravel,
        whole=lambda p: whole_params(p, s_specs, mesh, s_ravel))
    rec["tp_launches"] = ops.fused_cg_update.launches
    rec["tp_block"] = list(tp_params["blocks"][0]["qkv"]["w"].shape)
    rec["c_step_n"] = s_ravel.dim
    del cp_step, tp_step, tp_params
    dist.barrier()
    if rank == 0:
        rec["one_flops"] = forward_flops(fns, params, tokens)[0]
        (r_loss, r_grad, r_mvp, r_mv), rec["one_peak"] = values_and_peak(
            fns, config, ravel, params, batch, v)
        with precision_ctx(config):
            rec["one_mv_ms"] = statistics.median(host_ms(lambda: r_mvp(v),
                                                         5))
            r_hv = hessian_matvec(fns, params, tokens, ravel, v)
            one_cg = fixed_cg(lambda u: r_mvp(u) + config.damping * u,
                              -r_grad)
        ref = [r_loss, r_grad, r_mv, r_hv]
        rec["cp_values_rel"] = [rel(a, b) for a, b in zip(cp, ref)]
        rec["tp_values_rel"] = [rel(a, b) for a, b in zip(tp, ref)]
        for key, (x, m_hist) in solves.items():
            rec[key] = [rel(x, one_cg.x), rel(m_hist, one_cg.m_hist)]
        del r_grad, r_mvp, r_mv, r_hv, one_cg
        t_g = time.perf_counter()
        joined_decoder_reference(fns, config, ravel, params, batch, ema, rec)
        rec["g_time"] += time.perf_counter() - t_g
        del ref, ema
        one = functools.partial(optimizer.hf_step, fns=fns, config=config,
                                ravel=s_ravel)
        _, _, rec["c_ref_steps"], ref = timed_steps(one, s_params, s_state,
                                                    s_batch, 1, s_ravel)
        rec["cp_rel"] = [rel(a, b) for a, b in zip(cp_flats, ref)]
        rec["tp_rel"] = [rel(tp_flats[0], ref[0])]


def moe_problem(n_layers=LM["n_layers"]):
    """Phase 11's full-width MoE LM from the seed-0 start, of ``n_layers``
    blocks: ``(params, batch, fns, config, ravel)``."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_moe_decoder_lm(gen, n_experts=8, max_len=128,
                                        **dict(LM, n_layers=n_layers))
    tokens = affine_tokens(gen, 32, 128, LM["vocab"], "cuda")
    fns = pkg.HFModelFns(
        model_fn=functools.partial(
            models.moe_decoder_lm_apply, n_heads=LM["n_heads"],
            capacity_factor=1.25, router_groups=1, top_k=2),
        loss_outer=models.next_token_loss)
    config = pkg.HFConfig(damping=1.0, cg_max_iter=50)
    ravel = pkg.TrainableRavel(params, pad_to_multiple=1024)
    return params, (tokens, tokens), fns, config, ravel


def shard_moe(mesh, rank, rec):
    """15 d) on one rank: the full-width MoE LM's loss, gradient and one
    GGN matvec through the expert-parallel forward under
    ``moe_param_specs``; 15 g's same values under CP + EP and under
    Megatron specs on the attention beside them (:func:`joined_moe`); 1
    EP step at :data:`STEP_LAYERS` blocks with its peak.  Rank 0 then
    computes one process's loss, gradient, matvec and forward FLOPs, and
    the choices that capacity drops."""
    import torch.distributed as dist

    params, batch, fns, config, ravel = moe_problem()
    v = torch.randn(ravel.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(5))
    t_g = time.perf_counter()
    joined = joined_moe(fns, ravel, mesh, params, batch, v, rec)
    rec["g_time"] += time.perf_counter() - t_g
    layers = STEP_LAYERS["MoE LM"]
    s_params, s_batch, _, _, s_ravel = moe_problem(layers)
    specs = models.moe_param_specs(layers)
    rec["d_step_local"] = local_tree(sharded._Plan(
        fns, config, s_ravel, mesh, "data", "model", specs, None, "mean",
        stacked=False).enter(s_params, s_batch).params, s_params, specs,
        expert_split)
    step = sharded.make_sharded_hf_step(fns, config, s_ravel, mesh,
                                        param_specs=specs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # held before the step: the weights, the direction and the full-width
    # values of 15 d and g (a whole gradient and product per plan)
    rec["d_base"] = torch.cuda.memory_allocated()
    ops.fused_cg_update.launches = 0
    p, _, rec["d_steps"], _ = timed_steps(
        step, s_params, pkg.init_state(s_ravel, config), s_batch, 1, s_ravel,
        whole=lambda p: whole_params(p, specs, mesh, s_ravel))
    rec["d_launches"] = ops.fused_cg_update.launches
    rec["d_peak"] = torch.cuda.max_memory_allocated()
    rec["d_block"] = list(p["blocks"][0]["w1"].shape)
    rec["d_step_n"] = s_ravel.dim
    del step, p, s_params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        t_g = time.perf_counter()
        rec["g_dropped"] = dropped_choices(fns, params, batch[0])
        rec["g_one_flops"] = forward_flops(fns, params, batch[0])[0]
        with precision_ctx(config):
            r_loss, r_grad, r_mvp = optimizer._build_matvec_and_grad(
                fns, config, ravel, params, batch)
            ref = [r_loss, r_grad, r_mvp(v)]
        loss, _, mv = joined["ep"]
        rec["d_rel"] = [abs(float(loss) / float(r_loss) - 1),
                        rel(mv, ref[2])]
        for key, values in joined.items():
            rec[f"g_{key}_rel"] = [rel(a, b) for a, b in zip(values, ref)]
        rec["g_time"] += time.perf_counter() - t_g


def plan_values(fns, ravel, mesh, params, batch, v, param_specs=None,
                batch_specs=None, probe=None):
    """Loss, gradient and one GGN matvec as the sharded step computes them
    for these specs (``sharded._Plan.enter``: the specced weights entering
    as the blocks a step keeps, the local tree, the forward's axes, the
    reduction, the layout), the gradient and product gathered whole to
    compare: ``([loss, grad, mvp(v)], the matvec on this rank's blocks,
    the entry, the plan's ModelShard)``.  ``probe(mvp, v block)`` runs on
    the matvec before it is returned."""
    config = pkg.HFConfig(damping=1.0, cg_max_iter=50)
    plan = sharded._Plan(fns, config, ravel, mesh, "data", "model",
                         param_specs, batch_specs, "mean", stacked=False)
    e = plan.enter(spec_blocks(params, param_specs, mesh), batch)
    shard = plan.shard
    with collectives.axes(**e.axes), precision_ctx(plan.config):
        loss, grad, mvp = optimizer._build_matvec_and_grad(
            e.fns, plan.config, e.ravel, e.params, e.batch, e.reduce)
        values = [loss, shard.gather(grad), shard.gather(mvp(shard(v)))]
        if probe is not None:
            probe(mvp, shard(v))
        return values, mvp, e, shard


def dropped_choices(fns, params, tokens):
    """The top-2 choices that capacity drops in one process's forward of
    the MoE LM, over its layers."""
    counts = []
    dispatch = models.moe._topk_dispatch

    def counted(probs, capacity, top_k=2):
        out = dispatch(probs, capacity, top_k)
        counts.append(top_k * probs[..., 0].numel() - int(out[0].sum()))
        return out

    models.moe._topk_dispatch = counted
    try:
        with torch.no_grad():
            fns.model_fn(params, tokens)
    finally:
        models.moe._topk_dispatch = dispatch
    return sum(counts)


def joined_moe(fns, ravel, mesh, params, batch, v, rec):
    """15 d and 15 g on one rank: the full-width MoE LM's loss, gradient
    and GGN matvec under EP alone (15 d) and Megatron attention + EP (15
    g), through the step's plan, with each entry's forward FLOPs, local
    tree and peak; returns the values by combination."""
    P = pmesh.PartitionSpec
    specs = models.moe_param_specs(LM["n_layers"])
    mega = models.moe_param_specs(LM["n_layers"])
    for blk in mega["blocks"]:
        blk.update(qkv={"w": P(None, "model"), "b": P("model")},
                   proj={"w": P("model", None), "b": P()})
    out = {}
    def probe(mvp, vb):  # 15 d: the step's local tree and matvec
        _, rec["d_mv_bytes"] = gloo_bytes(lambda: mvp(vb))
        rec["d_mv_ms"] = statistics.median(host_ms(lambda: mvp(vb), 3))

    for key, kw in (("ep", dict(param_specs=specs, probe=probe)),
                    ("mega_ep", dict(param_specs=mega))):
        (values, mvp, e, _), rec[f"g_{key}_ms"], _, peak = with_peak(
            lambda: plan_values(fns, ravel, mesh, params, batch, v, **kw))
        del mvp
        name = "d" if key == "ep" else "g_mega_ep"
        rec[f"{name}_local"] = local_tree(
            e.params, params, kw["param_specs"],
            expert_split if key == "ep" else tensor_split)
        rec[f"{name}_values_peak"] = peak
        rec[f"g_{key}_flops"] = forward_flops(fns, e.params, e.batch[0],
                                              e.axes)[0]
        rec[f"g_{key}_roles"] = roles(e.axes)
        rec[f"g_{key}_grad"] = digest(values[1])
        out[key] = values
        del e
        gc.collect()
        torch.cuda.empty_cache()
    return out


def roles(axes):
    """The roles of more than one rank that a forward ran under."""
    return [k for k, a in axes.items()
            if isinstance(a, collectives.Axis) and a.size > 1]


def joined_decoder(fns, config, ravel, mesh, batch, mega_cp, rec):
    """15 g on one rank: the decoder LM's forward FLOPs under the Megatron
    specs + CP (``mega_cp``, the step's entry: whole weights, the rank's
    positions), and under CP the first EMA empirical-Fisher diagonal of
    the whole ``batch`` (fault F3) with its ms and peak, gathered whole."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), collectives.axes(**mega_cp.axes), \
            FlopCounterMode(display=False) as counter:
        fns.model_fn(mega_cp.params, mega_cp.batch[0])
    rec["g_flops"] = counter.get_total_flops()
    plan = sharded._Plan(fns, config, ravel, mesh, "data", "model", None,
                         pmesh.PartitionSpec(None, "model"), "mean",
                         stacked=False)
    e = plan.enter(mega_cp.params, batch)

    def first_ema():
        with collectives.axes(**e.axes), precision_ctx(config):
            d = optimizer._diag(e.fns, e.params, e.batch[0], e.batch[1],
                                config.precond_reduction, e.ravel, e.reduce)
        return pkg.EMADiag(0.9).update(plan.shard(d))

    ema, rec["g_diag_ms"], _, rec["g_diag_peak"] = with_peak(first_ema)
    rec["g_diag_block"] = ema.numel()
    rec["g_chunk_rows"] = max(1, sharded._ROW_CHUNK_BYTES // (
        plan.shard.block * ema.element_size()))
    return plan.shard.gather(ema)


def joined_decoder_reference(fns, config, ravel, params, batch, ema, rec):
    """15 g on rank 0: one process's ``diag_EF`` on the whole sequence
    against :func:`joined_decoder`'s, with its ms and peak."""
    def one_diag():
        with precision_ctx(config):
            return pkg.diag_EF(fns.model_fn, fns.loss_outer, params,
                               batch[0], batch[1], config.precond_reduction,
                               ravel)

    r_diag, rec["g_one_diag_ms"], _, rec["g_one_diag_peak"] = \
        with_peak(one_diag)
    rec["g_diag_rel"] = rel(ema, r_diag)


def shard_joined(mesh, rank, rec):
    """15 g) on one rank: the full-width MoE LM under CP + EP
    (``moe_param_specs`` and ``batch_specs=P(None, "model")``) on its first
    :data:`STEP_LAYERS` blocks, as 15 d's EP step: the loss, gradient and
    GGN matvec through the step's plan, on 15 h's direction (15 h holds
    them against its one-process values of the same blocks and batch,
    :data:`_HELD`), and 1 step with its peak and launches.  15 g's other
    values, at all 6 blocks, come from 15 c and 15 d, which share one
    process's references with them."""
    layers = STEP_LAYERS["MoE LM"]
    params, batch, fns, config, ravel = moe_problem(layers)
    specs = models.moe_param_specs(layers)
    t_g = time.perf_counter()
    values, mvp, e, _ = plan_values(
        fns, ravel, mesh, params, batch, rows_direction(ravel),
        param_specs=specs, batch_specs=pmesh.PartitionSpec(None, "model"))
    del mvp
    rec["g_cp_ep_roles"] = roles(e.axes)
    rec["g_cp_ep_grad"] = digest(values[1])
    _HELD["cp_ep"] = [t.cpu() for t in values]
    del values, e
    rec["g_cp_ep_ms"] = (time.perf_counter() - t_g) * 1e3
    step = sharded.make_sharded_hf_step(
        fns, config, ravel, mesh, param_specs=specs,
        batch_specs=pmesh.PartitionSpec(None, "model"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cg_update.launches = 0
    p, _, rec["g_steps"], _ = timed_steps(
        step, params, pkg.init_state(ravel, config), batch, 1, ravel,
        whole=lambda p: whole_params(p, specs, mesh, ravel))
    rec["g_launches"] = ops.fused_cg_update.launches
    rec["g_peak"] = torch.cuda.max_memory_allocated()
    rec["g_block"] = list(p["blocks"][0]["w1"].shape)
    rec["g_step_n"] = ravel.dim


def shard_rows(mesh, rank, rec):
    """15 h) on one rank of a (data 2, model 1) mesh: fault F5's check on
    the full-width MoE LM's first :data:`STEP_LAYERS` blocks with its rows
    split over the data axis (the default batch specs): the loss,
    gradient and GGN matvec through the step's plan (each rank's 16 rows
    routed with the other's), the FLOPs of the forward and of one MoE
    feed-forward, and 1 ``make_sharded_hf_step`` step with its launches
    and peak.  Rank 0 then computes one process's values and FLOPs on the
    whole batch and the choices that capacity drops."""
    import torch.distributed as dist

    params, batch, fns, config, ravel = moe_problem(STEP_LAYERS["MoE LM"])
    v = rows_direction(ravel)
    values, mvp, e, _ = plan_values(fns, ravel, mesh, params, batch, v)
    del mvp
    rec["h_roles"] = roles(e.axes)
    rec["h_grad"] = digest(values[1])
    rec["h_flops"], rec["h_moe_flops"] = moe_flops(fns, e.params, e.batch[0],
                                                   e.axes)
    step = sharded.make_sharded_hf_step(fns, config, ravel, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.fused_cg_update.launches = 0
    _, _, rec["h_steps"], _ = timed_steps(
        step, params, pkg.init_state(ravel, config), batch, 1, ravel)
    rec["h_launches"] = ops.fused_cg_update.launches
    rec["h_peak"] = torch.cuda.max_memory_allocated()
    rec["h_step_n"] = ravel.dim
    del step
    gc.collect()
    torch.cuda.empty_cache()
    held = _HELD.pop("cp_ep")
    dist.barrier()
    if rank == 0:
        rec["h_dropped"] = dropped_choices(fns, params, batch[0])
        rec["h_one_flops"], rec["h_one_moe_flops"] = moe_flops(
            fns, params, batch[0], {})
        with precision_ctx(config):
            loss, grad, mvp = optimizer._build_matvec_and_grad(
                fns, config, ravel, params, batch)
            ref = [loss, grad, mvp(v)]
        rec["h_rel"] = [rel(a, b) for a, b in zip(values, ref)]
        rec["g_cp_ep_rel"] = [rel(a, b.cpu()) for a, b in zip(held, ref)]


# 15 g's CP + EP values, held on the host until 15 h's one-process values
# of the same blocks and batch are computed
_HELD = {}


def rows_direction(ravel):
    """15 g's and 15 h's GGN matvec direction on the MoE LM's first
    :data:`STEP_LAYERS` blocks."""
    return torch.randn(ravel.dim, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(8))


def moe_flops(fns, params, tokens, axes):
    """The FLOPs (``FlopCounterMode``) of the MoE LM's forward on
    ``tokens`` under ``axes`` and of its first MoE feed-forward alone on an
    input of their shape (the FLOPs depend on the shapes alone)."""
    from torch.utils.flop_counter import FlopCounterMode

    whole = forward_flops(fns, params, tokens, axes)[0]
    h = torch.zeros(tuple(tokens.shape) + (LM["d_model"],), device="cuda")
    with torch.no_grad(), collectives.axes(**axes), \
            FlopCounterMode(display=False) as counter:
        models.moe._moe_ffn(params["blocks"][0], h, 1.25)
    return whole, counter.get_total_flops()


def f2_values(fns, config, params, batch, local, mesh, v, dtype):
    """The GSPMD names' reduced loss, gradient and GGN matvec on the
    ranks' rows (BatchNorm over both ranks' rows) in ``dtype``; on rank 0
    also one process's on the whole batch.  Returns their relative
    distances (rank 0) or ``None``."""
    def cast(tree):
        return tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                        else t, tree)

    params, batch, local, v = (cast(t) for t in (params, batch, local, v))
    ravel = pkg.TrainableRavel(params, pad_to_multiple=1024)
    with precision_ctx(config):
        with collectives.axes(batch=collectives.mesh_axis(mesh, "data")):
            loss, grad, mvp = optimizer._build_matvec_and_grad(
                fns, config, ravel, params, local,
                dp._Reduce(mesh, "data", "mean"))
            mv = mvp(v)
        if collectives.mesh_axis(mesh, "data").rank != 0:
            return None
        x, y = batch
        w_loss, w_grad = value_and_grad(lambda p: fns.full_loss(p, batch),
                                        params)
        w_mv = ravel.ravel(ggnvp(
            lambda p: fns.model_fn(p, x), lambda o: fns.loss_outer(o, y),
            params, ravel.unravel(v)))
    return [abs(float(loss) / float(w_loss) - 1),
            rel(grad, ravel.ravel(w_grad)), rel(mv, w_mv)]


def cudnn_vs_native(opt, batch, v):
    """One process: the f32 gradient and GGN matvec on ``batch`` with
    cuDNN's convolutions against the native ones (relative, norm-wise)."""
    fns, params, ravel = opt.fns, opt.params, opt.ravel
    x, y = batch
    values = []
    for enabled in (True, False):
        torch.backends.cudnn.enabled = enabled
        with precision_ctx(opt.config):
            grad = value_and_grad(lambda p: fns.full_loss(p, batch),
                                  params)[1]
            mv = ggnvp(lambda p: fns.model_fn(p, x),
                       lambda o: fns.loss_outer(o, y), params,
                       ravel.unravel(v))
        values.append((ravel.ravel(grad), ravel.ravel(mv)))
    torch.backends.cudnn.enabled = True
    (g, m), (g_native, m_native) = values
    return [rel(g, g_native), rel(m, m_native)]


def shard_f2(mesh, rank, rec):
    """15 e) on one rank of a (data 2) mesh: fault F2's check, the GSPMD
    names' reduced values against one process on the whole batch of 32, in
    f32 and in f64, and in f32 with cuDNN off; on rank 0 also one process's
    cuDNN-against-native distance on its 16 rows and on the 32."""
    opt, batch, _ = resnet_main_path()
    local = pmesh.shard_batch(batch, mesh)
    v = torch.randn(opt.ravel.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    args = (opt.fns, opt.config, opt.params, batch, local, mesh, v)
    rec["e32"] = f2_values(*args, torch.float32)
    rec["e64"] = f2_values(*args, torch.float64)
    torch.backends.cudnn.enabled = False
    rec["e32_native"] = f2_values(*args, torch.float32)
    torch.backends.cudnn.enabled = True
    if rank == 0:
        rec["cudnn16"] = cudnn_vs_native(opt, local, v)
        rec["cudnn32"] = cudnn_vs_native(opt, batch, v)


def shard_rank(rank, world, port, out_path):
    """One rank of 15 b) to e) (``chip_smoke.py --shard-rank``): gloo on
    the card, a (data 1, model 2) mesh and, for e), a (data 2) mesh over
    the same ranks; runs the parts in turn and writes its record."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    pdist.initialize_distributed(f"localhost:{port}", world, rank,
                                 backend="gloo", device="cuda:0")
    mesh = pmesh.make_mesh(axis_names=("data", "model"), shape=(1, world))
    data_mesh = pmesh.make_mesh()
    rows_mesh = pmesh.make_mesh(axis_names=("data", "model"),
                                shape=(world, 1))
    rec = {"rank": rank, "g_time": 0.0}
    for part, fn, on in (("b", shard_resnet, mesh), ("e", shard_f2, data_mesh),
                         ("c", shard_decoder, mesh), ("d", shard_moe, mesh),
                         ("g", shard_joined, mesh),
                         ("h", shard_rows, rows_mesh)):
        t0 = time.perf_counter()
        fn(on, rank, rec)
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
        rec[f"wall_{part}"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"rank {rank}/{world}: ok")


def two_ranks():
    """Run 15 b) to e) on two gloo ranks sharing the card; returns their
    records and the wall time."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--shard-rank",
             str(r), "2", str(port), paths[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"rank {r}/2: ok" not in out:
                raise AssertionError(f"15 b-e) rank {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
        return [json.load(open(path)) for path in paths], wall


def same_on_ranks(label, r0, r1, key):
    for a, b in zip(r0[key], r1[key]):
        if (a["iters"], a["params"]) != (b["iters"], b["params"]):
            raise AssertionError(f"{label}: the ranks differ: {r0[key]} vs "
                                 f"{r1[key]}")


def launches_of(label, rec, key, steps):
    iters = sum(s["iters"] for s in rec[steps])
    if rec[key] != iters:
        raise AssertionError(f"{label}: rank {rec['rank']}: {rec[key]} "
                             f"launches for {iters} CG iterations")
    return rec[key]


def phase_shard_resnet(r0, r1):
    wall = r0["wall_b"]
    same_on_ranks("15 b)", r0, r1, "b_steps")
    check_losses("15 b)", r0["b_steps"])
    if r0["b_block"] != MAIN_N // 2:
        raise AssertionError(f"15 b): CG block {r0['b_block']}")
    if not max(r0["cg_rel"]) <= 1e-5:
        raise AssertionError(f"15 b): the sharded fixed-length CG solve vs "
                             f"one process's: x, m {r0['cg_rel']}")
    launches = sum(launches_of("15 b)", r, "b_launches", "b_steps")
                   for r in (r0, r1))
    total, per_device = r0["b_est"]
    measured = r0["b_ref_peak"] - r0["b_peak"]
    iters = [s["iters"] for s in r0["b_steps"]]
    per_iter = r0["gather_ms"] + r0["ravel_ms"] + 2 * r0["dot_ms"]
    print(f"15 b) two gloo ranks sharing the card, (data 1, model 2) mesh "
          f"({wall:.1f} s), ResNet-18/MNIST b32, 1 "
          f"make_sharded_hf_step step: K1 on {r0['b_block']:,} elements "
          f"per rank; a {CG_CHECK_ITERS}-iteration CG solve (no stop) of "
          f"the first step's system on the ranks' blocks vs one process: "
          f"iterate {r0['cg_rel'][0]:.2e}, m-history {r0['cg_rel'][1]:.2e} "
          f"(norm-wise, <= 1e-5); the step's CG iterations {iters} against "
          f"one process's first {r0['b_ref_steps'][0]['iters']}, the first "
          f"step's parameters {r0['b_rel'][0]:.2e} and final loss "
          f"{r0['b_loss_rel'][0]:.2e} from one process's hf_step (relative;"
          f" no bound: f32 dots summed in two blocks can move Martens' "
          f"stop by an iteration); losses "
          f"{[(round(s['init'], 6), round(s['final'], 6)) for s in r0['b_steps']]}; "
          f"replicas bitwise equal; step ms "
          f"{[round(s['ms'], 1) for s in r0['b_steps']]} (rank 0) against "
          f"one process's {r0['b_ref_steps'][0]['ms']:.1f}; "
          f"peak requested bytes of the steps {gib(r0['b_peak']):.3f} GiB "
          f"(rank 0), {gib(r1['b_peak']):.3f} GiB (rank 1), one process "
          f"{gib(r0['b_ref_peak']):.3f} GiB: the difference "
          f"{measured / 2**20:.1f} MiB against the estimate's "
          f"total - per_device {(total - per_device) / 2**20:.1f} MiB "
          f"(solver_memory_bytes: {total / 2**20:.1f} MiB on one device, "
          f"{per_device / 2**20:.1f} MiB per rank of 2); gloo per CG "
          f"iteration {per_iter:.1f} ms (the direction's block laid out "
          f"to the whole local tree, one all-to-all, "
          f"{r0['gather_ms']:.1f} ms + the product's tree to the rank's "
          f"block, its own entries, {r0['ravel_ms']:.1f} ms + 2 scalar "
          f"reductions {r0['dot_ms']:.3f} ms each, host clock, rank 0); "
          f"fused_cg_update launches {r0['b_launches']} + {r1['b_launches']}"
          f" = the ranks' CG iterations")
    phase_f2(r0)
    return launches


# what each rank holds in a sharded step: the whole tree less the other
# rank's half of each partitioned leaf (15 c: the decoder LM under its
# Megatron specs, all but the layernorms, proj.b and ff2.b; 15 d: the MoE
# LM's expert leaves under moe_param_specs, at 6 and at 2 blocks)
TP_LOCAL = 9_762_304
EP_LOCAL = 57_324_544
EP_STEP_LOCAL = 19_502_080
# 15 g: Megatron attention + EP also halves each block's qkv (w and b) and
# proj.w
MEGA_EP_LOCAL = EP_LOCAL - LM["n_layers"] * (
    4 * LM["d_model"] ** 2 + 3 * LM["d_model"]) // 2


def moe_forward_flops(heads=1, experts=1, rows=32, T=128, n_experts=8,
                      dims=LM):
    """The MoE LM's forward FLOPs on one rank as ``FlopCounterMode``
    counts them (2 per multiply-add of its matmuls and einsums), reckoned
    from ``models/moe.py`` on ``rows`` x ``T`` tokens at capacity factor
    1.25, top-2, one router group, with the attention's heads split over
    ``heads`` ranks and the experts over ``experts``: per block the fused
    QKV and the projection (``8 G d^2``), the scores and values (``4 G T
    d``), the gate (``2 G d E``), the dispatch and the combine (``2 G E C
    d`` each) and the experts (``2 E C d f`` each way); the tied head
    ``2 G d V``."""
    d, f = dims["d_model"], dims["d_ff"]
    G = rows * T
    C = math.ceil(1.25 * 2 * G / n_experts)
    attention = (8 * G * d * d + 4 * G * T * d) // heads
    moe = 2 * G * d * n_experts + (4 * G * n_experts * C * d
                                   + 4 * n_experts * C * d * f) // experts
    return dims["n_layers"] * (attention + moe) + 2 * G * d * dims["vocab"]
# the entries of the whole weights whose cotangents a vjp summed over the
# tensor axis when the step gathered the weights (copy_to_axis): per
# block qkv w and b, proj.w, ff1 w and b, ff2.w; embed twice (the lookup
# and the tied head) and pos
MEGATRON_WEIGHT_SUMS = LM["n_layers"] * (
    4 * LM["d_model"] ** 2 + 3 * LM["d_model"]
    + 2 * LM["d_model"] * LM["d_ff"] + LM["d_ff"]) \
    + (2 * LM["vocab"] + 128) * LM["d_model"]


def check_local_tree(where, r, key, want):
    got = r[key]
    if got["entries"] != want or got["whole_block_leaf"]:
        raise AssertionError(f"{where} rank {r['rank']}: the step's local "
                             f"tree holds {got['entries']:,} entries "
                             f"against {want:,}, a whole partitioned leaf: "
                             f"{got['whole_block_leaf']}")


def phase_shard_decoder(r0, r1):
    wall = r0["wall_c"]
    if r0["c_step_n"] != CUT_N["decoder LM"]:
        raise AssertionError(f"15 c): the steps' flat dimension "
                             f"{r0['c_step_n']} is not phase 3's")
    for key in ("cp_steps", "tp_steps"):
        same_on_ranks("15 c)", r0, r1, key)
        check_losses(f"15 c) {key}", r0[key])
    if r0["tp_grad"] != r1["tp_grad"]:
        raise AssertionError("15 c): the ranks' gradients through the "
                             "partitioned forward differ")
    if not max(r0["cp_values_rel"] + r0["tp_values_rel"]) <= 1e-5:
        raise AssertionError(f"15 c): loss, gradient, GGN (and Hessian) "
                             f"matvec vs one process's: context parallel "
                             f"{r0['cp_values_rel']}, Megatron "
                             f"{r0['tp_values_rel']}")
    if not max(r0["cp_cg"] + r0["tp_cg"]) <= 1e-5:
        raise AssertionError(f"15 c): the fixed-length CG solves vs one "
                             f"process's: x, m under CP {r0['cp_cg']}, "
                             f"Megatron {r0['tp_cg']}")
    # the blocks' matmuls and the tied head's split in halves: one gather
    # of the embeddings' stream and one sum per sub-layer and of the head's
    # partial logits per forward
    want = (["tensor", "attention", "embed", "mlp", "pos"], 1,
            2 * LM["n_layers"] + 1)
    for r in (r0, r1):
        got = (r["tp_roles"], r["tp_gathers"], r["tp_sums"])
        if not (got == want and 2 * r["tp_flops"] == r0["one_flops"]):
            raise AssertionError(f"15 c): rank {r['rank']}: forward FLOPs "
                                 f"{r['tp_flops']} against one process's "
                                 f"{r0['one_flops']}, roles, gathers, sums "
                                 f"{got} against {want}: not split in "
                                 f"halves")
        check_local_tree("15 c)", r, "tp_local", TP_LOCAL)
    ref = r0["c_ref_steps"]
    bounds = []
    for key, rels in (("cp_steps", r0["cp_rel"]), ("tp_steps", r0["tp_rel"])):
        # a first step at one process's CG iterations took the same
        # decisions, so its parameters differ by rounding alone
        same = r0[key][0]["iters"] == ref[0]["iters"]
        if same and not rels[0] <= 1e-5:
            raise AssertionError(f"15 c) {key}: the first step at one "
                                 f"process's CG iterations lies {rels[0]} "
                                 f"from its parameters")
        bounds.append("<= 1e-5, the CG iterations agree" if same
                      else "no bound: the CG iterations differ")
    launches = sum(launches_of("15 c)", r, "cp_launches", "cp_steps")
                   + launches_of("15 c)", r, "tp_launches", "tp_steps")
                   for r in (r0, r1))
    tpv = r0["tp_values_rel"]
    tpb, tpl = r0["tp_mv_bytes"], r0["tp_local"]
    gathered = tpb["all_reduce"] + 4 * DENSE_LM_N + 4 * MEGATRON_WEIGHT_SUMS
    print(f"15 c) the same two ranks ({wall:.1f} s), the "
          f"full-width decoder LM ({DENSE_LM_N:,} parameters, b32 x T128): "
          f"context parallel (batch_specs=P(None, 'model'), 64 + 64 "
          f"positions; beside the Megatron specs, whose blocks the plan "
          f"computes gathered: 15 g): loss, gradient, GGN matvec vs one "
          f"process "
          f"{r0['cp_values_rel'][0]:.2e}, {r0['cp_values_rel'][1]:.2e}, "
          f"{r0['cp_values_rel'][2]:.2e} (relative, norm-wise, <= 1e-5); "
          f"Megatron param_specs (qkv w block {r0['tp_block']} per rank; "
          f"each rank computes {LM['n_heads'] // 2} of {LM['n_heads']} "
          f"heads and {LM['d_ff'] // 2} of {LM['d_ff']} feed-forward "
          f"columns per block, 2 gloo sums per block, and "
          f"{LM['d_model'] // 2} of {LM['d_model']} features of embed and "
          f"pos and of the tied head's contraction: per forward "
          f"{r0['tp_gathers']} gather of the [32, 128, {LM['d_model']}] "
          f"stream and {r0['tp_sums']} sums, {2 * LM['n_layers']} of the "
          f"blocks and 1 of the [32, 128, {LM['vocab']}] logits): loss, "
          f"gradient, GGN and Hessian (one-shot) matvecs vs one process "
          f"{tpv[0]:.2e}, {tpv[1]:.2e}, {tpv[2]:.2e}, {tpv[3]:.2e} (<= "
          f"1e-5), the ranks' gradients bitwise equal; each rank's local "
          f"tree in the step {tpl['entries']:,} entries ({TP_LOCAL:,} "
          f"predicted), {tpl['bytes'] / 1e6:.2f} MB (whole: "
          f"{4 * DENSE_LM_N / 1e6:.2f} MB), its largest leaf "
          f"{tpl['largest']}, no leaf at a whole partitioned leaf's "
          f"shape; one GGN matvec hands gloo "
          f"{tpb['all_reduce'] / 1e6:.1f} MB of all-reduce buffers in "
          f"{tpb['all_reduce_calls']} calls and "
          f"{tpb['all_to_all'] / 1e6:.1f} MB of all-to-all sends in "
          f"{tpb['all_to_all_calls']} (CUDA tensors, no host copy) "
          f"({(tpb['all_reduce'] + tpb['all_to_all']) / 1e6:.1f} MB; "
          f"the gathered-weights form, computed: {gathered / 1e6:.1f} MB with "
          f"the "
          f"direction's {4 * DENSE_LM_N / 1e6:.1f} MB gather and the whole "
          f"weights' {4 * MEGATRON_WEIGHT_SUMS / 1e6:.1f} MB of cotangent "
          f"sums); forward FLOPs per "
          f"rank {r0['tp_flops']:,} / {r1['tp_flops']:,} against one "
          f"process's {r0['one_flops']:,} "
          f"({r0['tp_flops'] / r0['one_flops']:.2%}: exactly half); peak "
          f"requested bytes of one gradient + build "
          f"+ GGN matvec per rank {gib(r0['tp_peak']):.3f} / "
          f"{gib(r1['tp_peak']):.3f} GiB partitioned (gathered weights: "
          f"6.315), "
          f"{gib(r0['plain_peak']):.3f} / {gib(r1['plain_peak']):.3f} GiB "
          f"with replicated weights (param_specs=None), one process "
          f"{gib(r0['one_peak']):.3f} GiB; GGN matvec "
          f"{r0['tp_mv_ms']:.1f} ms partitioned (gloo on one card, host "
          f"clock, median of 5, rank 0) against one process's "
          f"{r0['one_mv_ms']:.1f} ms; the partitioned "
          f"embeddings and head add per pass a gloo sum of the [32, 128, "
          f"{LM['vocab']}] logits {r0['tp_logits_sum_ms']:.1f} ms and a "
          f"gather of the [32, 128, {LM['d_model']}] stream "
          f"{r0['tp_stream_gather_ms']:.1f} ms (median of 5); a "
          f"{CG_CHECK_ITERS}-iteration CG solve (no stop) of the start's "
          f"system on the ranks' blocks vs one process's: iterate "
          f"{r0['cp_cg'][0]:.2e}, m-history {r0['cp_cg'][1]:.2e} under CP, "
          f"{r0['tp_cg'][0]:.2e}, {r0['tp_cg'][1]:.2e} under Megatron "
          f"(norm-wise, <= 1e-5); the steps on the first "
          f"{STEP_LAYERS['decoder LM']} of the {LM['n_layers']} blocks "
          f"({r0['c_step_n']:,} parameters, K1 on {r0['c_step_n'] // 2:,} "
          f"per rank): 1 CP step: CG iterations "
          f"{[s['iters'] for s in r0['cp_steps']]} (one process's first "
          f"{ref[0]['iters']}), parameters from one process's hf_step "
          f"{r0['cp_rel'][0]:.2e} ({bounds[0]}), losses "
          f"{[(round(s['init'], 6), round(s['final'], 6)) for s in r0['cp_steps']]}; "
          f"1 Megatron step: {r0['tp_steps'][0]['iters']} CG iterations, "
          f"parameters {r0['tp_rel'][0]:.2e} from one process's "
          f"({bounds[1]}), loss {r0['tp_steps'][0]['init']:.6f} -> "
          f"{r0['tp_steps'][0]['final']:.6f}; replicas bitwise equal; step "
          f"ms CP {[round(s['ms'], 1) for s in r0['cp_steps']]}, Megatron "
          f"{round(r0['tp_steps'][0]['ms'], 1)}, one process "
          f"{ref[0]['ms']:.1f}; launches {launches} = the ranks' CG "
          f"iterations")
    return launches


def phase_shard_moe(r0, r1):
    wall = r0["wall_d"]
    if r0["d_step_n"] != CUT_N["MoE LM"]:
        raise AssertionError(f"15 d): the step's flat dimension "
                             f"{r0['d_step_n']} is not phase 3's")
    same_on_ranks("15 d)", r0, r1, "d_steps")
    check_losses("15 d)", r0["d_steps"])
    if not max(r0["d_rel"]) <= 1e-5:
        raise AssertionError(f"15 d): loss, matvec {r0['d_rel']}")
    for r in (r0, r1):
        check_local_tree("15 d)", r, "d_local", EP_LOCAL)
        check_local_tree("15 d)", r, "d_step_local", EP_STEP_LOCAL)
        if r["g_ep_flops"] != moe_forward_flops(experts=2):
            raise AssertionError(f"15 d) rank {r['rank']}: forward FLOPs "
                                 f"{r['g_ep_flops']:,} under EP against "
                                 f"the reckoned "
                                 f"{moe_forward_flops(experts=2):,}")
    if r0["g_ep_roles"] != ["expert"]:
        raise AssertionError(f"15 d): the forward ran under the axes "
                             f"{r0['g_ep_roles']}, not the expert axis")
    launches = sum(launches_of("15 d)", r, "d_launches", "d_steps")
                   for r in (r0, r1))
    s = r0["d_steps"][0]
    db, dl = r0["d_mv_bytes"], r0["d_local"]
    print(f"15 d) the same two ranks ({wall:.1f} s), the "
          f"full-width MoE LM ({MOE_N:,} parameters) under moe_param_specs "
          f"(w1 block {r0['d_block']}: 4 of 8 experts per rank): loss and "
          f"one GGN matvec through the expert-parallel forward (one "
          f"replicated program: the model axis reduces no loss) vs one "
          f"process's {r0['d_rel'][0]:.2e}, {r0['d_rel'][1]:.2e} (relative,"
          f" norm-wise, <= 1e-5); forward FLOPs per rank "
          f"{r0['g_ep_flops']:,} (reckoned {moe_forward_flops(experts=2):,};"
          f" one process's {r0['g_one_flops']:,}); the loss, gradient and "
          f"matvec {r0['g_ep_ms'] / 1e3:.1f} s (with the matvec's probe "
          f"below; 15 g's Megatron + EP {r0['g_mega_ep_ms'] / 1e3:.1f} s), "
          f"peak requested bytes "
          f"{gib(r0['d_values_peak']):.3f} / "
          f"{gib(r1['d_values_peak']):.3f} GiB; each rank's local tree in "
          f"the step "
          f"{dl['entries']:,} entries ({EP_LOCAL:,} predicted), "
          f"{dl['bytes'] / 1e6:.1f} MB (whole: {4 * MOE_N / 1e6:.1f} MB), "
          f"its largest leaf {dl['largest']}, no leaf at a whole "
          f"partitioned leaf's shape; one GGN matvec hands gloo "
          f"{db['all_reduce'] / 1e6:.1f} MB of all-reduce buffers in "
          f"{db['all_reduce_calls']} calls and "
          f"{db['all_to_all'] / 1e6:.1f} MB of all-to-all sends in "
          f"{db['all_to_all_calls']} (the gathered-weights "
          f"form adds the direction's {4 * MOE_N / 1e6:.1f} MB gather and "
          f"drops the all-to-alls) and takes {r0['d_mv_ms']:.1f} ms (host "
          f"clock, median of 3); 1 step on the first "
          f"{STEP_LAYERS['MoE LM']} of the {LM['n_layers']} blocks "
          f"({r0['d_step_n']:,} parameters, K1 on {r0['d_step_n'] // 2:,} "
          f"per rank): loss {s['init']:.6f} -> "
          f"{s['final']:.6f}, {s['iters']} CG iterations on both ranks, "
          f"{s['ms']:.1f} ms, replicas bitwise equal, its local tree "
          f"{r0['d_step_local']['entries']:,} entries per rank "
          f"({EP_STEP_LOCAL:,} predicted); peak memory per rank "
          f"{gib(r0['d_peak']):.2f} / {gib(r1['d_peak']):.2f} GiB, of which "
          f"{gib(r0['d_base']):.2f} / {gib(r1['d_base']):.2f} GiB held "
          f"before the step (the weights, the direction and the full-width "
          f"values of 15 d and g); "
          f"launches {launches} = the ranks' CG "
          f"iterations")
    return launches


def phase_shard_joined(r0, r1):
    step_wall, wall = r0["wall_g"], r0["wall_g"] + r0["g_time"]
    if r0["g_step_n"] != CUT_N["MoE LM"]:
        raise AssertionError(f"15 g): the step's flat dimension "
                             f"{r0['g_step_n']} is not phase 3's")
    same_on_ranks("15 g)", r0, r1, "g_steps")
    check_losses("15 g)", r0["g_steps"])
    launches = sum(launches_of("15 g)", r, "g_launches", "g_steps")
                   for r in (r0, r1))
    rels = {"ep": r0["g_ep_rel"], "cp_ep": r0["g_cp_ep_rel"],
            "mega_ep": r0["g_mega_ep_rel"],
            "mega_cp": r0["cp_values_rel"][:3]}
    if not max(max(v) for v in rels.values()) <= 1e-5:
        raise AssertionError(f"15 g): loss, gradient, GGN matvec vs one "
                             f"process's: {rels}")
    for key in rels:
        if r0[f"g_{key}_grad"] != r1[f"g_{key}_grad"]:
            raise AssertionError(f"15 g) {key}: the ranks' gradients differ")
    # 15 c's CP values come from the mega_cp plan, which computes the
    # blocks gathered: when a joint Megatron + CP partition changes these
    # roles, 15 c must compare the CP-alone plan's values again
    roles = {"ep": ["expert"], "cp_ep": ["sequence", "expert"],
             "mega_ep": ["expert", "tensor"], "mega_cp": ["sequence"]}
    for key, want in roles.items():
        if r0[f"g_{key}_roles"] != want:
            raise AssertionError(f"15 g) {key}: the forward ran under the "
                                 f"axes {r0[f'g_{key}_roles']}, not {want}")
    # Megatron attention + EP: each rank's heads and experts
    for r in (r0, r1):
        check_local_tree("15 g)", r, "g_mega_ep_local", MEGA_EP_LOCAL)
        if r["g_mega_ep_flops"] != moe_forward_flops(heads=2, experts=2):
            raise AssertionError(
                f"15 g) rank {r['rank']}: forward FLOPs {r['g_mega_ep_flops']:,}"
                f" under Megatron attention + EP against the reckoned "
                f"{moe_forward_flops(heads=2, experts=2):,}")
    if r0["g_one_flops"] != moe_forward_flops():
        raise AssertionError(f"15 g): one process's MoE LM forward FLOPs "
                             f"{r0['g_one_flops']:,} against the reckoned "
                             f"{moe_forward_flops():,}")
    if not r0["g_dropped"] > 0:
        raise AssertionError("15 g): capacity dropped no choice, so the "
                             "gathered routing was not exercised")
    # CP alone splits the work: every matmul sees half the positions
    if not (r0["g_flops"] == r1["g_flops"]
            and 2 * r0["g_flops"] == r0["one_flops"]):
        raise AssertionError(f"15 g): forward FLOPs per rank under the "
                             f"Megatron specs + CP {r0['g_flops']}, "
                             f"{r1['g_flops']} against one process's "
                             f"{r0['one_flops']}")
    if not r0["g_diag_rel"] <= 1e-5:
        raise AssertionError(f"15 g): the first EMA diagonal under CP vs "
                             f"one process's diag_EF: {r0['g_diag_rel']}")
    s = r0["g_steps"][0]
    d_step = r0["d_steps"][0]
    cp_ep, mega_ep, mega_cp = (rels[k] for k in ("cp_ep", "mega_ep",
                                                 "mega_cp"))
    print(f"15 g) the same two ranks ({wall:.1f} s: the CP + EP values "
          f"and step {step_wall:.1f} s, the rest inside 15 c and d "
          f"{r0['g_time']:.1f} s on rank 0), where the model "
          f"axis's roles meet: the full-width MoE LM ({MOE_N:,} parameters)"
          f" under CP + EP (moe_param_specs and batch_specs=P(None, "
          f"'model'); attention on 64 of 128 positions, the MoE on all "
          f"4,096 tokens on 4 of 8 experts): on the first "
          f"{STEP_LAYERS['MoE LM']} blocks, loss, gradient, GGN matvec vs "
          f"one process (15 h's) {cp_ep[0]:.2e}, {cp_ep[1]:.2e}, "
          f"{cp_ep[2]:.2e} (relative, norm-wise, <= 1e-5; "
          f"{r0['g_cp_ep_ms'] / 1e3:.1f} s); capacity drops "
          f"{r0['g_dropped']} of {2 * 32 * 128 * LM['n_layers']:,} top-2 "
          f"choices in one process's forward (> 0); 1 step on the first "
          f"{STEP_LAYERS['MoE LM']} of the {LM['n_layers']} blocks "
          f"({r0['g_step_n']:,} parameters, w1 block {r0['g_block']}, K1 "
          f"on {r0['g_step_n'] // 2:,} per rank): loss {s['init']:.6f} -> "
          f"{s['final']:.6f}, {s['iters']} CG iterations on both ranks "
          f"(15 d's EP step: {d_step['iters']}), {s['ms']:.1f} ms (15 d: "
          f"{d_step['ms']:.1f} ms), replicas bitwise equal; peak memory per "
          f"rank {gib(r0['g_peak']):.2f} / {gib(r1['g_peak']):.2f} GiB "
          f"(15 d's EP step {gib(r0['d_peak']):.2f} GiB); launches "
          f"{launches} = the ranks' CG iterations")
    ml = r0["g_mega_ep_local"]
    print(f"15 g) the MoE LM under Megatron attention + EP (roles "
          f"{r0['g_mega_ep_roles']}: each rank computes 4 of 8 heads and 4 "
          f"of 8 experts, one replicated program): loss, gradient, GGN "
          f"matvec vs one process {mega_ep[0]:.2e}, {mega_ep[1]:.2e}, "
          f"{mega_ep[2]:.2e} (<= 1e-5); forward FLOPs per rank "
          f"{r0['g_mega_ep_flops']:,} = the reckoned "
          f"{moe_forward_flops(heads=2, experts=2):,} "
          f"({r0['g_mega_ep_flops'] / r0['g_one_flops']:.2%} of one "
          f"process's {r0['g_one_flops']:,}; EP alone "
          f"{r0['g_ep_flops'] / r0['g_one_flops']:.2%}); local tree "
          f"{ml['entries']:,} entries ({MEGA_EP_LOCAL:,} predicted; EP "
          f"alone {r0['d_local']['entries']:,}), no partitioned leaf whole; "
          f"peak requested bytes of the loss, gradient and matvec "
          f"{gib(r0['g_mega_ep_values_peak']):.3f} / "
          f"{gib(r1['g_mega_ep_values_peak']):.3f} GiB (EP alone "
          f"{gib(r0['d_values_peak']):.3f}); the decoder LM ({DENSE_LM_N:,} "
          f"parameters) under its Megatron specs + CP (the blocks gathered,"
          f" the sequence split): {mega_cp[0]:.2e}, {mega_cp[1]:.2e}, "
          f"{mega_cp[2]:.2e} (<= 1e-5), forward FLOPs per rank "
          f"{r0['g_flops']:,} against one process's {r0['one_flops']:,}"
          f" (exactly half: the CP split alone); the ranks' gradients "
          f"bitwise equal")
    print(f"15 g) fault F3: the decoder LM b32's first EMA diagonal under "
          f"CP (each sample's gradient summed over the model axis in "
          f"chunks of {r0['g_chunk_rows']} rows, {r0['g_diag_block']:,} "
          f"entries squared per rank) vs one process's diag_EF on the "
          f"whole sequence {r0['g_diag_rel']:.2e} (<= 1e-5); "
          f"{r0['g_diag_ms']:.1f} / {r1['g_diag_ms']:.1f} ms (host clock, "
          f"two ranks at once) against one process's "
          f"{r0['g_one_diag_ms']:.1f} ms; peak requested bytes "
          f"{gib(r0['g_diag_peak']):.3f} / {gib(r1['g_diag_peak']):.3f} GiB"
          f" per rank against one process's "
          f"{gib(r0['g_one_diag_peak']):.3f} GiB")
    return launches


def phase_shard_rows(r0, r1):
    if r0["h_step_n"] != CUT_N["MoE LM"]:
        raise AssertionError(f"15 h): the step's flat dimension "
                             f"{r0['h_step_n']} is not phase 3's")
    same_on_ranks("15 h)", r0, r1, "h_steps")
    check_losses("15 h)", r0["h_steps"])
    if r0["h_roles"] != ["batch"]:
        raise AssertionError(f"15 h): the forward ran under the axes "
                             f"{r0['h_roles']}, not the batch axis")
    if not max(r0["h_rel"]) <= 1e-5:
        raise AssertionError(f"15 h): loss, gradient, GGN matvec vs one "
                             f"process's: {r0['h_rel']}")
    if r0["h_grad"] != r1["h_grad"]:
        raise AssertionError("15 h): the ranks' gradients differ")
    if not r0["h_dropped"] > 0:
        raise AssertionError("15 h): capacity dropped no choice, so routing "
                             "across the rows was not exercised")
    # every rank routes and runs the whole batch's tokens in its MoE
    if not r0["h_moe_flops"] == r1["h_moe_flops"] == r0["h_one_moe_flops"]:
        raise AssertionError(f"15 h): a MoE feed-forward's FLOPs per rank "
                             f"{r0['h_moe_flops']}, {r1['h_moe_flops']} "
                             f"against one process's {r0['h_one_moe_flops']}")
    launches = sum(launches_of("15 h)", r, "h_launches", "h_steps")
                   for r in (r0, r1))
    rel_ = r0["h_rel"]
    s = r0["h_steps"][0]
    layers = STEP_LAYERS["MoE LM"]
    print(f"15 h) fault F5, the same two ranks as a (data 2, model 1) mesh "
          f"({r0['wall_h']:.1f} s), the full-width MoE LM on the first "
          f"{layers} of the {LM['n_layers']} blocks ({r0['h_step_n']:,} "
          f"parameters; 8 experts, top-2, capacity 1.25, b32 x T128, f32) "
          f"with its rows split over the data axis (16 + 16 rows; each MoE "
          f"layer gathers both ranks' rows and routes all 4,096 tokens as "
          f"one process does): loss, gradient, GGN matvec vs one process on "
          f"the whole batch {rel_[0]:.2e}, {rel_[1]:.2e}, {rel_[2]:.2e} "
          f"(relative, norm-wise, <= 1e-5), the ranks' gradients bitwise "
          f"equal; capacity drops {r0['h_dropped']} of "
          f"{2 * 32 * 128 * layers:,} top-2 choices in one process's "
          f"forward (> 0); forward FLOPs per rank {r0['h_flops']:,} / "
          f"{r1['h_flops']:,} against one process's {r0['h_one_flops']:,} "
          f"({r0['h_flops'] / r0['h_one_flops']:.2%}), of which one MoE "
          f"feed-forward {r0['h_moe_flops']:,} per rank against one "
          f"process's {r0['h_one_moe_flops']:,} (the whole group on every "
          f"rank); 1 step (K1 on {r0['h_step_n']:,}): loss "
          f"{s['init']:.6f} -> {s['final']:.6f}, {s['iters']} CG "
          f"iterations on both ranks, {s['ms']:.1f} ms, replicas bitwise "
          f"equal; peak memory per rank {gib(r0['h_peak']):.2f} / "
          f"{gib(r1['h_peak']):.2f} GiB; launches {launches} = the ranks' "
          f"CG iterations")
    return launches


def phase_f2(r0):
    e32, e64, native = r0["e32"], r0["e64"], r0["e32_native"]
    c16, c32 = r0["cudnn16"], r0["cudnn32"]
    # with cuDNN, each rank convolves 16 rows and one process 32: the two
    # differ by at most cuDNN's own error at those batch sizes (one
    # process, cuDNN against the native convolutions) and the native gap
    cudnn_bound = [10 * (a + b) + 1e-5 for a, b in zip(c16, c32)]
    if not (max(e64) <= 1e-10 and max(native) <= 1e-5
            and e32[0] <= 1e-5 and e32[1] <= cudnn_bound[0]
            and e32[2] <= cudnn_bound[1]):
        raise AssertionError(
            f"15 e): the GSPMD names' values vs the whole batch: f64 {e64}, "
            f"f32 without cuDNN {native}, f32 with cuDNN {e32} against "
            f"{cudnn_bound} (cuDNN vs native, one process: batch 16 {c16}, "
            f"batch 32 {c32})")
    print(f"15 e) fault F2, the same two ranks as a (data 2) mesh "
          f"({r0['wall_e']:.1f} s), "
          f"ResNet-18/MNIST b32 as 2 x 16 under the GSPMD names (BatchNorm "
          f"over both ranks' rows): reduced loss, gradient, GGN matvec vs "
          f"one process on the whole batch of 32, relative, norm-wise: f64 "
          f"{e64[0]:.2e}, {e64[1]:.2e}, {e64[2]:.2e} (<= 1e-10); f32 with "
          f"cuDNN off {native[0]:.2e}, {native[1]:.2e}, {native[2]:.2e} (<= "
          f"1e-5); f32 with cuDNN {e32[0]:.2e}, {e32[1]:.2e}, {e32[2]:.2e} "
          f"(<= 1e-5, {cudnn_bound[0]:.2e}, {cudnn_bound[1]:.2e}: 10 x "
          f"cuDNN's own distance from the native convolutions in one "
          f"process, gradient and matvec, on rank 0's 16 rows "
          f"{c16[0]:.2e}, {c16[1]:.2e} plus on the 32 {c32[0]:.2e}, "
          f"{c32[1]:.2e}, + 1e-5); each rank's rows alone: phase 14 b")


MODEL_AXIS_EXAMPLES = (
    ("run_sharded.py", ["--tp"], "done."),
    ("run_sharded.py", ["--megatron"], "done."),
    ("run_context_parallel.py", ["--tiny"],
     "next-token loss down under sequence splitting; done."),
    ("run_moe_lm.py", ["--ep", "--tiny"],
     "next-token loss down through routed experts; done."))


# what an example must also print: run_sharded.py --tp's column split
# over the two ranks (SIZES (7, 16, 16, 4))
EXAMPLE_LINES = {"run_sharded.py --tp": "each rank computes 8 of 16, 8 of "
                                        "16, 2 of 4 output columns per layer"}


def check_model_axis_examples(handles):
    """15 f): the four model-axis examples, started before phase 12 (or 15
    a, alone); returns
    their launches."""
    launches = 0
    for (script, flags, done), handle in zip(MODEL_AXIS_EXAMPLES, handles):
        returncode, out, err, wall = wait_example(handle)
        line = EXAMPLE_LINES.get(" ".join([script, *flags]))
        if returncode != 0 or out.count(done) != 1 \
                or (line is not None and out.count(line) != 1):
            raise AssertionError(f"{script} exited {returncode}:\n"
                                 f"{out}\n{err[-4000:]}")
        steps = [line for line in out.splitlines() if line.startswith("step ")]
        if len(steps) != len(set(steps)):
            raise AssertionError(f"{script}: more than one rank printed")
        n = example_launches(script, out, 2)
        launches += n
        print(f"15 f) {script} {' '.join(flags)} --backend gloo under "
              f"torch.distributed.run --nproc-per-node 2 (the four started "
              f"before phase 12): exit 0, read {wall:.1f} s after its start, "
              f"{len(steps)} steps printed once (rank 0)"
              + (f", '{line}'" if line else "")
              + f", launches {n} = both ranks' CG iterations")
    return launches


def phase_model_axis():
    """Phase 15 (module docstring); returns the kernel launches."""
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    launches = phase_shard_nccl()
    gc.collect()
    torch.cuda.empty_cache()
    # f) started before (all wait on the host far more than on the card)
    examples = EARLY.pop("15 f", None) or model_axis_examples()
    (r0, r1), wall = two_ranks()
    print(f"15 b-e, g, h) two gloo ranks sharing the card: {wall:.1f} s "
          f"with start-up")
    launches += phase_shard_resnet(r0, r1)
    launches += phase_shard_decoder(r0, r1)
    launches += phase_shard_moe(r0, r1)
    launches += phase_shard_joined(r0, r1)
    launches += phase_shard_rows(r0, r1)
    launches += check_model_axis_examples(examples)
    torch.backends.cudnn.deterministic = False
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return launches


def phase_data_parallel():
    """Phase 14 (module docstring); returns the kernel launches."""
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    # d) beside a-c: they wait on the host far more than on the card
    (example,) = start_examples([("run_allcnnc_cifar100.py", ["--dp"], 2)])
    launches = phase_dp_nccl()
    gc.collect()
    torch.cuda.empty_cache()
    launches += phase_dp_two_ranks()
    launches += check_dp_example(example)
    torch.backends.cudnn.deterministic = False
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return launches



PIPE_MICRO = 4  # 16 b): 32 rows as 4 microbatches of 8 over 2 stages


def pipelined_decoder(mesh, n_microbatches, remat=False):
    """``HFModelFns`` of the decoder LM with its blocks run as a GPipe
    pipeline over the ``stage`` axis of ``mesh``
    (examples_torch/run_pipeline_parallel.py's model at phase 10's width)."""
    def block_fn(blk, h):
        return _block(blk, h, LM["n_heads"], causal=True)

    if remat:
        block_fn = checkpoint(block_fn)

    def apply(params, tokens):
        x = params["embed"][tokens] + params["pos"][:tokens.shape[1]]
        x = pipeline.pipeline_blocks(stack_blocks(params["blocks"]), x,
                                     block_fn, mesh,
                                     n_microbatches=n_microbatches)
        return _layernorm(params["ln_f"], x) @ params["embed"].T

    return pkg.HFModelFns(model_fn=apply, loss_outer=models.next_token_loss)


def phase_pipe_nccl():
    """16 a): NCCL on a 1-rank (stage 1) mesh, one microbatch; one pipelined
    ``hf_step`` against the sequential one, bit for bit.  Returns the
    pipelined step's launches."""
    import torch.distributed as dist

    pdist.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                 backend="nccl", device="cuda:0")
    mesh = pmesh.make_mesh(axis_names=("stage",))
    params, batch, fns, config, ravel = decoder_problem()
    state = pkg.init_state(ravel, config)
    runs = []
    for model in (fns, pipelined_decoder(mesh, 1)):
        ops.fused_cg_update.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = optimizer.hf_step(params, state, batch, fns=model,
                                config=config, ravel=ravel)
        torch.cuda.synchronize()
        runs.append((out, (time.perf_counter() - t0) * 1e3,
                     ops.fused_cg_update.launches))
    ((rp, rs, rst), ref_ms, _), ((gp, gs, gst), ms, launches) = runs
    if not (torch.equal(ravel.ravel(rp), ravel.ravel(gp))
            and same_state(rs, gs) and rst.num_cg_iters == gst.num_cg_iters
            and torch.equal(rst.init_loss, gst.init_loss)
            and torch.equal(rst.final_loss, gst.final_loss)):
        raise AssertionError(
            f"16 a): the 1-stage pipelined step differs from hf_step: cg "
            f"{gst.num_cg_iters} vs {rst.num_cg_iters}, losses "
            f"{float(gst.init_loss)} -> {float(gst.final_loss)} vs "
            f"{float(rst.init_loss)} -> {float(rst.final_loss)}")
    if launches != gst.num_cg_iters:
        raise AssertionError(f"16 a): {launches} launches for "
                             f"{gst.num_cg_iters} CG iterations")
    print(f"16 a) NCCL, 1-rank (stage 1) mesh, one microbatch: the pipelined "
          f"hf_step on the decoder LM ({DENSE_LM_N:,} parameters, b32 x "
          f"T128) from the seed-0 start equals the sequential hf_step bit "
          f"for bit (parameters, state, {gst.num_cg_iters} CG iterations, "
          f"losses {float(gst.init_loss):.6f} -> "
          f"{float(gst.final_loss):.6f}); step {ms:.1f} ms against "
          f"{ref_ms:.1f} ms sequential; fused_cg_update launches {launches} "
          f"= CG iterations")
    dist.destroy_process_group()
    pdist._device = None
    return launches


def pipe_rank(rank, world, port, out_path):
    """One rank of 16 b) (``chip_smoke.py --pipe-rank``): gloo on the card,
    a (stage 2) mesh, the decoder LM's 6 blocks as 3 per stage over
    :data:`PIPE_MICRO` microbatches; rank 0 then computes one process's
    sequential values, solve, forward and step.  Writes its record."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    pdist.initialize_distributed(f"localhost:{port}", world, rank,
                                 backend="gloo", device="cuda:0")
    mesh = pmesh.make_mesh(axis_names=("stage",))
    axis = collectives.mesh_axis(mesh, "stage")
    params, batch, fns, config, ravel = decoder_problem()
    tokens = batch[0]
    state = pkg.init_state(ravel, config)
    pipe = pipelined_decoder(mesh, PIPE_MICRO)
    v = torch.randn(ravel.dim, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(6))
    rec = {"rank": rank}
    t0 = time.perf_counter()
    with precision_ctx(config):
        loss, grad, mvp = optimizer._build_matvec_and_grad(
            pipe, config, ravel, params, batch)
        mv = mvp(v)
        solve = fixed_cg(lambda u: mvp(u) + config.damping * u, -grad)
        del mvp
        # one-shot (the CPU tests hold the linearized form through the
        # schedule)
        hv = hessian_matvec(pipe, params, tokens, ravel, v)
        outs = {f"M={m}": pipelined_decoder(mesh, m).model_fn(params, tokens)
                for m in (1, 2, 8)}
        outs["M=4, remat"] = pipelined_decoder(
            mesh, PIPE_MICRO, remat=True).model_fn(params, tokens)
    mb = torch.randn(32 // PIPE_MICRO, 128, LM["d_model"], device="cuda")
    # in turns with the all-reduce of every stage's microbatch that a
    # shift was before (an S-fold zero-filled buffer)
    shift = [lambda: collectives.ppermute(mb, axis),
             lambda: collectives._gather(mb.unsqueeze(0), axis, 0)]
    times = [[], []]
    for _ in range(3):
        for i, fn in enumerate(shift):
            times[i] += host_ms(fn, 4)
    rec["shift_ms"], rec["shift_reduce_ms"] = map(statistics.median, times)
    _, rec["shift_bytes"] = gloo_bytes(shift[0])
    rec["shift_block"] = mb.numel() * mb.element_size()
    rec["blocks_n"] = sum(t.numel() for t in tree_flatten(params["blocks"])[0])
    cotangent = torch.randn(rec["blocks_n"], device="cuda")
    rec["blocks_sum_ms"] = statistics.median(
        host_ms(lambda: collectives._reduce(cotangent, axis), 5))
    del mb, cotangent
    rec["wall_values"] = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = functools.partial(optimizer.hf_step, fns=pipe, config=config,
                             ravel=ravel)
    ops.fused_cg_update.launches = 0
    _, _, rec["steps"], flats = timed_steps(step, params, state, batch, 1,
                                            ravel)
    rec["launches"] = ops.fused_cg_update.launches
    rec["peak"] = torch.cuda.max_memory_allocated()
    dist.barrier()
    if rank == 0:
        with precision_ctx(config):
            r_loss, r_grad, r_mvp = optimizer._build_matvec_and_grad(
                fns, config, ravel, params, batch)
            rec["values_rel"] = [abs(float(loss) / float(r_loss) - 1),
                                 rel(grad, r_grad), rel(mv, r_mvp(v)),
                                 rel(hv, hessian_matvec(fns, params, tokens,
                                                        ravel, v))]
            one = fixed_cg(lambda u: r_mvp(u) + config.damping * u, -r_grad)
            rec["cg_rel"] = [rel(solve.x, one.x),
                             rel(solve.m_hist, one.m_hist)]
            del r_grad, r_mvp, one
            seq = fns.model_fn(params, tokens)
            rec["fwd_rel"] = {k: rel(o, seq) for k, o in outs.items()}
        del grad, mv, hv, solve, outs, seq
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        one_step = functools.partial(optimizer.hf_step, fns=fns,
                                     config=config, ravel=ravel)
        _, _, rec["ref_steps"], ref = timed_steps(one_step, params, state,
                                                  batch, 1, ravel)
        rec["ref_peak"] = torch.cuda.max_memory_allocated()
        rec["step_rel"] = rel(flats[0], ref[0])
    dist.barrier()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    print(f"rank {rank}/{world}: ok")


def start_pipe_ranks():
    """Start 16 b)'s two gloo ranks (this script with ``--pipe-rank``),
    their output and records in a directory of their own
    (:func:`stop_examples` stops them and removes it); returns what
    :func:`phase_pipe_two_ranks` takes."""
    port = free_port()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    handles = []
    for r in range(2):
        files = [open(os.path.join(tmp, f"rank{r}.{kind}"), "w+")
                 for kind in ("out", "err")]
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--pipe-rank",
             str(r), "2", str(port), os.path.join(tmp, f"rank{r}.json")],
            stdout=files[0], stderr=files[1], text=True)
        handles.append((proc, files, time.perf_counter()))
    _STARTED.append((tmp, handles))
    return tmp, handles


def phase_pipe_two_ranks(started):
    """16 b): two gloo ranks sharing the card, started by
    :func:`start_pipe_ranks`; returns both ranks' step launches."""
    tmp, handles = started
    for r, handle in enumerate(handles):
        returncode, out, err, wall = wait_example(handle, timeout=900)
        if returncode != 0 or f"rank {r}/2: ok" not in out:
            raise AssertionError(f"16 b) rank {r} exited {returncode}:\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")
    r0, r1 = (json.load(open(os.path.join(tmp, f"rank{r}.json")))
              for r in range(2))
    same_on_ranks("16 b)", r0, r1, "steps")
    check_losses("16 b)", r0["steps"])
    launches = sum(launches_of("16 b)", r, "launches", "steps")
                   for r in (r0, r1))
    if not max(r0["values_rel"] + r0["cg_rel"]) <= 1e-5:
        raise AssertionError(f"16 b): loss, gradient, GGN and Hessian "
                             f"matvecs {r0['values_rel']}, the CG solve "
                             f"{r0['cg_rel']}")
    if not max(r0["fwd_rel"].values()) <= 1e-5:
        raise AssertionError(f"16 b): forwards {r0['fwd_rel']}")
    # one shift hands gloo the rank's microbatch alone, in one all-to-all
    for r in (r0, r1):
        sb = r["shift_bytes"]
        if (sb["all_reduce_calls"], sb["all_to_all_calls"],
                sb["all_to_all"]) != (0, 1, r["shift_block"]):
            raise AssertionError(f"16 b) rank {r['rank']}: one shift "
                                 f"handed gloo {sb}, not one block of "
                                 f"{r['shift_block']} bytes")
    ref = r0["ref_steps"][0]
    # a first step at one process's CG iterations took the same decisions,
    # so its parameters differ by rounding alone
    same = r0["steps"][0]["iters"] == ref["iters"]
    if same and not r0["step_rel"] <= 1e-5:
        raise AssertionError(f"16 b): the first step at one process's CG "
                             f"iterations lies {r0['step_rel']} from its "
                             f"parameters")
    bound = ("<= 1e-5, the CG iterations agree" if same
             else "no bound: the CG iterations differ")
    values = ", ".join(f"{x:.2e}" for x in r0["values_rel"])
    fwd = ", ".join(f"{k} {x:.2e}" for k, x in r0["fwd_rel"].items())
    print(f"16 b) two gloo ranks sharing the card, (stage 2) mesh (read "
          f"{wall:.1f} s after their start; the values "
          f"{r0['wall_values']:.1f} s), the decoder LM's 6 blocks as 3 per stage, {PIPE_MICRO} "
          f"microbatches of {32 // PIPE_MICRO} (bubble 1/{PIPE_MICRO + 1}): "
          f"loss, gradient, GGN matvec, Hessian matvec vs one process's "
          f"sequential ones {values} (relative, norm-wise, <= 1e-5); a "
          f"{CG_CHECK_ITERS}-iteration CG solve (no stop) of the start's "
          f"system vs one process's: iterate {r0['cg_rel'][0]:.2e}, "
          f"m-history {r0['cg_rel'][1]:.2e} (<= 1e-5); forwards {fwd} (<= "
          f"1e-5); 1 pipelined hf_step: CG iterations "
          f"{[s['iters'] for s in r0['steps']]} (one process's first "
          f"{ref['iters']}), the first step's parameters from one process's "
          f"{r0['step_rel']:.2e} ({bound}), losses "
          f"{[(round(s['init'], 6), round(s['final'], 6)) for s in r0['steps']]}, "
          f"replicas bitwise equal; step ms "
          f"{[round(s['ms'], 1) for s in r0['steps']]} (rank 0), "
          f"{[round(s['ms'], 1) for s in r1['steps']]} (rank 1) against one "
          f"process's {ref['ms']:.1f}; gloo: one tick's shift of "
          f"[{32 // PIPE_MICRO}, 128, {LM['d_model']}] f32 "
          f"{r0['shift_ms']:.2f} ms, handing gloo "
          f"{r0['shift_bytes']['all_to_all']:,} bytes in one all-to-all "
          f"(one microbatch), against {r0['shift_reduce_ms']:.2f} ms for "
          f"the all-reduce of both stages' ({2 * r0['shift_block']:,} "
          f"bytes; median of 12 each, in turns), the blocks' cotangent sum "
          f"([{r0['blocks_n']:,}] f32) {r0['blocks_sum_ms']:.1f} ms (median, "
          f"host clock, rank 0); peak memory per rank {gib(r0['peak']):.2f}"
          f" / {gib(r1['peak']):.2f} GiB against one process's "
          f"{gib(r0['ref_peak']):.2f} GiB; fused_cg_update launches "
          f"{r0['launches']} + {r1['launches']} = the ranks' CG iterations")
    return launches


PIPE_EXAMPLE_DONE = "next-token loss halved through the pipelined model; done."


def check_pipe_example(handle):
    """16 c): the pipeline example, started before phase 14 (or 16 a,
    alone); returns its four ranks' launches."""
    returncode, out, err, wall = wait_example(handle)
    if returncode != 0 or out.count(PIPE_EXAMPLE_DONE) != 1:
        raise AssertionError(f"run_pipeline_parallel.py exited "
                             f"{returncode}:\n{out}\n{err[-4000:]}")
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    if len(steps) != 6 or len(steps) != len(set(steps)):
        raise AssertionError(f"run_pipeline_parallel.py: steps {steps}")
    launches = example_launches("run_pipeline_parallel.py", out, 4)
    for line in steps:
        print(f"    | {line}")
    print(f"16 c) run_pipeline_parallel.py --backend gloo under "
          f"torch.distributed.run --nproc-per-node 4 (4 stages on the card, "
          f"started early): exit 0, read {wall:.1f} s after its start, "
          f"the loss halved, each step printed once (rank 0); launches "
          f"{launches} = the four ranks' CG iterations")
    return launches


def pipeline_runs():
    """Start 16 b)'s ranks and 16 c)'s example."""
    return (start_pipe_ranks(),
            start_examples([("run_pipeline_parallel.py", [], 4)])[0])


def phase_pipeline():
    """Phase 16 (module docstring); returns the kernel launches."""
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    # b) and c) beside a, or from before phase 14 in the whole script:
    # their ranks wait on the host far more than on the card
    ranks, example = EARLY.pop("16 b-c", None) or pipeline_runs()
    launches = phase_pipe_nccl()
    gc.collect()
    torch.cuda.empty_cache()
    launches += phase_pipe_two_ranks(ranks)
    launches += check_pipe_example(example)
    torch.backends.cudnn.deterministic = False
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; it runs on a GPU.")

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    print(smi)

    # full f32 everywhere: a step sets this for itself (HFConfig's
    # matmul_precision), and the matvecs measured outside a step must run
    # as the step runs them; cuDNN's default is TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build("fused_cg_update.cu")
    _build.load("fused_cg_update.cu")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    try:
        if sys.argv[1:2] == ["--phase"]:
            {"3": phase_kernel, "14": phase_data_parallel,
             "15": phase_model_axis, "16": phase_pipeline}[sys.argv[2]]()
        else:
            run_all_phases(name)
    finally:
        stop_examples()


def run_all_phases(name):
    """Phases 3-16, then the ``kernels`` line and the ``ok`` line."""
    clock = [time.perf_counter()]

    def lap(phases):
        now = time.perf_counter()
        print(f"phases {phases}: {now - clock[0]:.1f} s")
        clock[0] = now

    record = phase_kernel()
    phase_cg()
    phase_small_slice()
    lap("3-5")
    launches = phase_main()
    lap(6)
    phase_allcnnc_narrow()
    steps, acc_matvec_ms = phase_allcnnc()
    launches += steps
    lap("7-8")
    phase_lm_narrow()
    lap(9)
    launches += phase_decoder_lm()
    lap(10)
    launches += phase_moe_lm()
    lap(11)
    EARLY["15 f"] = model_axis_examples()
    EARLY["13 b"] = start_flagship()
    steps, store_peaks = phase_resnet_features()
    launches += steps
    lap(12)
    launches += phase_front_door(acc_matvec_ms, store_peaks)
    lap(13)
    EARLY["16 b-c"] = pipeline_runs()
    launches += phase_data_parallel()
    launches += phase_model_axis()
    launches += phase_pipeline()

    print(json.dumps({"kernels": [{
        "name": "fused_cg_update",
        "route": "cuda",
        "source": "pytorchhessianfree_tpu_torch/csrc/fused_cg_update.cu",
        "replaces": "ff5bf90:pytorchhessianfree_tpu/ops/pallas_kernels.py:49",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "call_ms": record["call_ms"],
        "host_ms": record["host_us"] / 1e3,
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                sys.argv[5])
    elif sys.argv[1:2] == ["--shard-rank"]:
        shard_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                   sys.argv[5])
    elif sys.argv[1:2] == ["--pipe-rank"]:
        pipe_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
    else:
        main()
