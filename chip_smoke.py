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
   diagonal and of one accumulated matvec.

The ``kernels`` line counts the kernel's launches on the two paths (phases
6 and 8); the launches of the comparisons do not count.

It needs a CUDA device and ``nvcc`` (the CUDA toolkit), and imports no JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

import pytorchhessianfree_tpu_torch as pkg
from pytorchhessianfree_tpu_torch import _build, accumulate, models, optimizer
from pytorchhessianfree_tpu_torch.ops import cg_update as ops
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten, tree_map

MAIN_N = 11_175_936  # ResNet-18/MNIST flat dimension, padded to 1024
ALLCNNC_PARAMS = 1_387_108
ALLCNNC_N = 1_387_520  # All-CNN-C/CIFAR-100 flat dimension, padded to 1024
NARROW_SEED = 0  # phase 7's weights and batch
RAGGED_N = 1_000_003
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


def phase_kernel():
    """Kernel against plain on the card, at the n of both paths and a
    ragged n; returns the main-size f32 record."""
    record = {}
    for n in (MAIN_N, ALLCNNC_N, RAGGED_N):
        for dtype in (torch.float32, torch.float64):
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
                main_args = args

    kernel = lambda: ops.fused_cg_update(*main_args)  # noqa: E731
    plain = lambda: ops.fused_cg_update_reference(*main_args)  # noqa: E731
    cuda_ms(kernel, 5)  # warm up
    cuda_ms(plain, 5)
    # in turns: plain, kernel, kernel, plain
    plain_t = cuda_ms(plain, 25)
    kernel_t = cuda_ms(kernel, 25) + cuda_ms(kernel, 25)
    plain_t += cuda_ms(plain, 25)
    record["ms"] = statistics.median(kernel_t)
    record["plain_ms"] = statistics.median(plain_t)
    print(f"fused_cg_update n={MAIN_N} f32, median of 50 CUDA-event-timed "
          f"calls: kernel {record['ms']:.4f} ms, plain {record['plain_ms']:.4f}"
          f" ms (kernel moves {7 * 4 * MAIN_N / 1e6:.0f} MB: "
          f"{7 * 4 * MAIN_N / record['ms'] / 1e6:.0f} GB/s)")
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


def same_history(gpu, cpu):
    """Card and CPU runs of the same steps: the same CG decisions, and
    losses within 1e-9 (step 0) and 1e-6 (step 1)."""
    for key in ("num_cg_iters", "cg_reasons", "best_cg_iters", "dampings"):
        if gpu[key] != cpu[key]:
            raise AssertionError(f"{key}: card {gpu[key]} CPU {cpu[key]}")
    for i, rtol in enumerate((1e-9, 1e-6)):
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


def phase_main():
    """The main path: 3 HF steps of full-width ResNet-18/MNIST b32."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = models.init_resnet18(gen, device="cuda")
    count = sum(t.numel() for t in tree_flatten(params)[0])
    if count != 11_175_370:
        raise AssertionError(f"ResNet-18 has {count} parameters")
    x = torch.randn((32, 28, 28, 1), generator=gen, device="cuda")
    y = torch.randint(0, 10, (32,), generator=gen, device="cuda")
    opt = pkg.HessianFree(
        params,
        model_fn=models.resnet18_apply,
        loss_outer=models.cross_entropy_loss,
        config=pkg.HFConfig(damping=1.0, cg_max_iter=50),
        pad_to_multiple=1024,
    )
    if opt.ravel.dim != MAIN_N:
        raise AssertionError(f"flat dimension {opt.ravel.dim}")
    print(f"main path: ResNet-18, {count} parameters, flat dim "
          f"{opt.ravel.dim}, batch 32 x 28x28x1, GGN, cg_max_iter=50, f32")

    ops.fused_cg_update.launches = 0
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step((x, y))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        s, h = opt.last_stats, opt.history
        print(f"step {i}: loss {h['init_losses'][i]:.6f} -> "
              f"{h['final_losses'][i]:.6f} | damping {float(s.damping):.6f} "
              f"-> {float(s.new_damping):.6f} | cg {s.num_cg_iters} iters "
              f"({h['cg_reasons'][i]}) | best iter {s.best_cg_iter} | lr "
              f"{h['learning_rates'][i]:.6f} | {ms:.1f} ms")
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
    print(f"fused_cg_update launches on the main path: {launches} = total "
          f"CG iterations {h['num_cg_iters']}")

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

    print(json.dumps({"kernels": [{
        "name": "fused_cg_update",
        "route": "cuda",
        "source": "pytorchhessianfree_tpu_torch/csrc/fused_cg_update.cu",
        "replaces": "ff5bf90:pytorchhessianfree_tpu/ops/pallas_kernels.py:49",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
