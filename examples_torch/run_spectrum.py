"""Curvature-spectrum diagnostics during Hessian-free training.

Beyond-reference capability (the reference exposes no spectral tooling,
SURVEY.md §2.3): while training a small MLP with the HF optimizer, probe the
LIVE curvature operator each step --

- top/bottom Ritz values of the GGN (how stiff is the quadratic model; is
  the current LM damping in the right decade relative to lambda_max?),
- the most negative Hessian eigenvalue (saddle diagnostics; the GGN is PSD
  by construction, the Hessian need not be),
- an SLQ trace estimate + coarse spectral-density sketch of the GGN bulk.

Everything is matrix-free (Lanczos on the same matvec closures CG
consumes).  Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

import torch
from example_utils import generator, get_device, get_small_nn_problem, report

from pytorchhessianfree_tpu_torch import HessianFree, slq_density, slq_trace
from pytorchhessianfree_tpu_torch.models import mlp_apply, mse_loss

if __name__ == "__main__":
    device = get_device()
    print(f"Running spectrum diagnostics on {device}")
    params, batch = get_small_nn_problem(generator(device), N=32)
    opt = HessianFree(
        params, model_fn=mlp_apply, loss_outer=mse_loss, damping=1.0
    )
    n = opt.ravel.unpadded_dim

    for step_idx in range(3):
        ggn = opt.estimate_spectrum(batch, num_iters=30)
        hess = opt.estimate_spectrum(batch, num_iters=30, curvature="hessian")
        lam_max = float(ggn.values[0])
        damping = float(opt.state.damping)
        print(
            f"  [pre-step {step_idx}] GGN lambda_max {lam_max:.4f} "
            f"(residual bound {float(ggn.residual_bounds[0]):.2e}) | "
            f"GGN lambda_min {float(ggn.values[-1]):.2e} | "
            f"Hessian lambda_min {float(hess.values[-1]):.4f} | "
            f"damping/lambda_max {damping / lam_max:.3f}"
        )
        opt.step(batch)
        report(step_idx, opt)

    # SLQ bulk view of the final GGN: trace + a coarse density sketch.
    res, (nodes, weights) = opt.estimate_spectrum(
        batch, num_iters=20, num_probes=16
    )
    tr = float(slq_trace(nodes, weights, n))
    print(f"\nSLQ: n = {n}, trace(GGN) ~= {tr:.4f} "
          f"(mean eigenvalue ~= {tr / n:.6f})")
    lam_max = float(res.values[0])
    grid = torch.linspace(0.0, 1.05 * lam_max, 40, device=nodes.device,
                          dtype=nodes.dtype)
    dens = slq_density(nodes, weights, grid, sigma=0.04 * lam_max)
    dens = dens / float(torch.max(dens))
    print("spectral density (log-ish sketch, x: lambda, #: relative mass):")
    for i in range(0, 40, 4):
        d = float(dens[i])
        bar = "#" * max(1, int(40 * d)) if d > 1e-4 else ""
        print(f"  {float(grid[i]):8.4f} | {bar}")
