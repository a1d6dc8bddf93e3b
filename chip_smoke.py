#!/usr/bin/env python3
"""Drive the PyTorch port (``pytorchhessianfree_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises, so the script exits non-zero and
prints no ``ok`` line:

1. the device: its name, and name and power limit from ``nvidia-smi``;
2. the kernel build from ``pytorchhessianfree_tpu_torch/csrc``;
3. the CUDA ``fused_cg_update`` against its plain PyTorch version on the
   card (f32 and f64, at the n of phases 6 and 8 and at a ragged n),
   bitwise reproducibility of its
   reductions, and both versions' times at the main path's n;
4. CG on the card (kernel) against CG on the CPU (plain version) in f64;
5. a narrow ResNet-18 HF step on the card against the same step on the CPU
   in f64;
6. the main path: 3 Hessian-free steps of the full-width ResNet-18 (MNIST
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
   2 HF steps each on the card against the same steps on the CPU in f64,
   and the narrow encoder classifier's forward on both;
10. the full-width decoder LM (19,505,152 parameters, batch 32 x T 128 of
    the affine next-token rule on vocab 1024, GGN,
    ``HFConfig(damping=1.0, cg_max_iter=50)``, f32): 3 steps, the build,
    matvec and peak memory, a bf16-curvature step from the same start with
    its matvec held against f32, and a T 1024 point whose chunked matvecs
    (linearized; one-shot; one-shot and rematerialized) are held against
    full attention, with the peak memory of each;
11. the full-width MoE decoder LM (8 experts, top-2, capacity 1.25, one
    router group; 107,717,632 parameters): 2 steps, matvec and peak memory;
12. the rest of the optimizer on the main path (ResNet-18/MNIST b32 as in
    phase 6, ``cudnn.deterministic`` on): a) a rank-32 Nystrom sketch of the
    GGN (eigenvalues >= 0 and descending, orthonormal columns, the sketch
    below the operator along its top direction; build time and peak
    memory); e) the Ritz values of a 32-step Lanczos run and a 4-probe SLQ
    whose trace must equal ``dim * mean_p(v_p^T A v_p)``; b) the next
    step's damped system solved by CG plain, with the iterates stored in
    bf16 (the same iteration bit for bit, a bf16 buffer) and with the
    Nystrom preconditioner; c) 2 Nystrom-preconditioned steps with
    ``rich_stats`` (a finite m-history, ``format_rich_stats``); d) a
    sequential and a batched selection step from one saved state (the same
    CG iterations, shared losses within rtol 1e-4, the same selection
    unless its margin is below that); f) a bf16-stored and an f32-stored
    step from that state (the same CG iterations, reason and m-history bit
    for bit; peak memory of each); g) ``save`` / ``load`` into a fresh
    optimizer with both backends, one step each, bitwise equal.

Phases 10 and 11 also read the card's busy share from a ``torch.profiler``
trace of 5 matvecs.

Phase 3 also holds the kernel against its plain version at the flat
dimensions of phases 10 and 11 and times it at the n of each path beside
its bound.  The ``kernels`` line counts the kernel's launches on the four
paths (phases 6, 8, 10 and 11) and the steps of phase 12; the launches of
the comparisons and of phase 12's standalone CG solves do not count.

It needs a CUDA device and ``nvcc`` (the CUDA toolkit), and imports no JAX.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

import pytorchhessianfree_tpu_torch as pkg
from pytorchhessianfree_tpu_torch import _build, accumulate, models, optimizer
from pytorchhessianfree_tpu_torch.ops import cg_update as ops
from pytorchhessianfree_tpu_torch.ops.curvature import ggnvp, value_and_grad
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten, tree_map

MAIN_N = 11_175_936  # ResNet-18/MNIST flat dimension, padded to 1024
ALLCNNC_PARAMS = 1_387_108
ALLCNNC_N = 1_387_520  # All-CNN-C/CIFAR-100 flat dimension, padded to 1024
DENSE_LM_N = 19_505_152  # decoder LM parameters = flat dimension
MOE_N = 107_717_632  # MoE decoder LM parameters = flat dimension
PATH_N = {"ResNet-18": MAIN_N, "All-CNN-C": ALLCNNC_N,
          "decoder LM": DENSE_LM_N, "MoE LM": MOE_N}
NARROW_SEED = 0  # phase 7's weights and batch
RAGGED_N = 1_000_003
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
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


def phase_kernel():
    """Kernel against plain on the card, at the n of every path and a
    ragged n, and its time at the n of every path; returns the main-size
    f32 record."""
    record = {}
    checks = [(n, dtype) for n in (MAIN_N, ALLCNNC_N, RAGGED_N, DENSE_LM_N)
              for dtype in (torch.float32, torch.float64)]
    checks.append((MOE_N, torch.float32))
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

    for path, n in PATH_N.items():
        args = kernel_inputs(n, torch.float32, seed=1)
        kernel = functools.partial(ops.fused_cg_update, *args)
        plain = functools.partial(ops.fused_cg_update_reference, *args)
        cuda_ms(kernel, 5)  # warm up
        cuda_ms(plain, 5)
        # in turns: plain, kernel, kernel, plain
        plain_t = cuda_ms(plain, 25)
        kernel_t = cuda_ms(kernel, 25) + cuda_ms(kernel, 25)
        plain_t += cuda_ms(plain, 25)
        ms, plain_ms = statistics.median(kernel_t), statistics.median(plain_t)
        bound = kernel_bound_ms(n)
        print(f"fused_cg_update n={n} f32 ({path}), median of 50 "
              f"CUDA-event-timed calls: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms (moves "
              f"{7 * 4 * n / 1e6:.0f} MB: {7 * 4 * n / ms / 1e6:.0f} GB/s, "
              f"{bound / ms:.0%} of the bound)")
        if n == MAIN_N:
            record.update(ms=ms, plain_ms=plain_ms, bound_ms=bound)
        del args, kernel, plain
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
    """The main path: 3 HF steps of full-width ResNet-18/MNIST b32."""
    opt, (x, y), gen = resnet_main_path()
    count = opt.ravel.unpadded_dim
    if opt.ravel.dim != MAIN_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    print(f"main path: ResNet-18, {count} parameters, flat dim "
          f"{opt.ravel.dim}, batch 32 x 28x28x1, GGN, cg_max_iter=50, f32")

    launches = run_steps(opt, (x, y), 3, "the main path")

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
    full-width All-CNN-C on CIFAR-100 shapes, batch 256 in 4 chunks."""
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
    times = cuda_ms(lambda: mvp(v), 10)
    print(f"accumulated GGN matvec (2 chunks of 64, jvp + vjp per chunk): "
          f"median {statistics.median(times):.2f} ms over 10 (CUDA events), "
          f"{statistics.median(times) / 2:.2f} ms per chunk")
    return launches


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
    """The narrow decoder LM and MoE LM, 2 HF steps each on the card and on
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
            for _ in range(2):
                opt.step((tokens.to(dev), tokens.to(dev)))
            runs.append(opt.history)
        gpu, cpu = runs
        same_history(gpu, cpu, rtols=(1e-9, 1e-9))
        print(f"narrow {name} f64, 2 HF steps card vs CPU: cg iters "
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
    """3 HF steps of the full-width decoder LM, a bf16-curvature step from
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
    launches = run_steps(opt, batch, 3, "the decoder LM path")
    print(f"decoder LM steps: peak memory "
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
    """2 HF steps of the full-width MoE decoder LM."""
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
    launches = run_steps(opt, batch, 2, "the MoE LM path")
    print(f"MoE LM steps: peak memory "
          f"{gib(torch.cuda.max_memory_allocated()):.2f} GiB")
    lm_matvec(opt, batch, gen, "MoE LM")
    return launches


def with_peak(fn):
    """``(fn(), ms, peak)``: the host-clock time of ``fn`` and the peak
    device memory it allocates above what was allocated before it."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, torch.cuda.max_memory_allocated() - base


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
    of its steps."""
    torch.backends.cudnn.deterministic = True  # for the bitwise checks
    opt, batch, _ = resnet_main_path(rich_stats=True)
    ravel = opt.ravel
    n = ravel.unpadded_dim
    print(f"phase 12: ResNet-18/MNIST b32 as in phase 6 (flat dim "
          f"{ravel.dim}, {n} parameters), rich_stats, cuDNN deterministic")

    # a) the sketch of the GGN at the start
    def sketch_gen():
        return torch.Generator("cuda").manual_seed(1)

    sketch, ms, peak = with_peak(lambda: opt.get_nystrom_sketch(
        batch, rank=32, generator=sketch_gen()))
    U, eigs = sketch
    orth = float((U.T @ U - torch.eye(32, device="cuda")).abs().max())
    # the build's share, then the sketch again from the built matvec
    (_, grad, mvp), build_ms, _ = with_peak(
        lambda: optimizer._build_matvec_and_grad(
            opt.fns, opt.config, ravel, opt.params, batch))
    probes = pkg.normalized_probes(sketch_gen(), 32, n, ravel.dtype,
                                   pad_to=ravel.dim)
    again, again_ms, _ = with_peak(lambda: pkg.nystrom_sketch(mvp, probes))
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

    (ritz_res, (nodes, weights)), ms, peak = with_peak(
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

    launches = run_steps(opt, batch, 2, "phase 12's preconditioned steps",
                         each=detail_finite, precond_lowrank=sketch)
    text = pkg.format_rich_stats(opt.last_stats).splitlines()
    m_lines = [ln for ln in text if "  m = " in ln]
    rest = [ln for ln in text if "  m = " not in ln]
    print(f"c) format_rich_stats of the last step, {len(text)} lines; "
          f"{rest[0]} {m_lines[0].strip()} ... {m_lines[-1].strip()}")
    print("\n".join(rest[1:]))
    del sketch

    # d) sequential and batched selection from one saved state
    saved, start = opt.state_dict(), opt.params
    runs = {}
    for mode in ("sequential", "batched"):
        o = resnet_opt(start, rich_stats=True, backtracking_mode=mode,
                       linesearch=pkg.LineSearchConfig(mode=mode))
        o.load_state_dict(saved)
        launches += run_steps(o, batch, 1, f"the {mode} selection step")
        runs[mode] = o
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

    # f) bf16-stored against f32-stored iterates, one step each
    stats, peaks = {}, {}
    for store in (None, "bfloat16"):
        o = resnet_opt(start, rich_stats=True,
                       cg=pkg.CGConfig(store_dtype=store))
        o.load_state_dict(saved)
        steps, _, peaks[store] = with_peak(functools.partial(
            run_steps, o, batch, 1, f"the {store or 'float32'}-stored step"))
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
          f"of the step {gib(peaks[None]):.3f} vs "
          f"{gib(peaks['bfloat16']):.3f} GiB above the baseline")
    del stats, a, b, start

    # g) save, load into a fresh optimizer, one step each
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("torch", "npz"):
            path = os.path.join(tmp, f"ckpt-{backend}")
            opt.save(path, backend=backend)
            fresh = resnet_opt(opt.params, rich_stats=True)
            fresh.load(path, backend=backend)
            launches += run_steps(opt, batch, 1, "the saved optimizer")
            launches += run_steps(fresh, batch, 1, f"the {backend}-loaded one")
            if not (opt.history == fresh.history
                    and torch.equal(ravel.ravel(opt.params),
                                    ravel.ravel(fresh.params))
                    and all(torch.equal(x, y)
                            for x, y in zip(opt.state, fresh.state))):
                raise AssertionError(f"{backend}: the resumed step differs")
            print(f"g) {backend} backend: save, load into a fresh optimizer, "
                  f"one step each: parameters, state and history equal bit "
                  f"for bit")
            del fresh
    torch.backends.cudnn.deterministic = False
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

    record = phase_kernel()
    phase_cg()
    phase_small_slice()
    launches = phase_main()
    phase_allcnnc_narrow()
    launches += phase_allcnnc()
    phase_lm_narrow()
    launches += phase_decoder_lm()
    launches += phase_moe_lm()
    launches += phase_resnet_features()

    print(json.dumps({"kernels": [{
        "name": "fused_cg_update",
        "route": "cuda",
        "source": "pytorchhessianfree_tpu_torch/csrc/fused_cg_update.cu",
        "replaces": "ff5bf90:pytorchhessianfree_tpu/ops/pallas_kernels.py:49",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
