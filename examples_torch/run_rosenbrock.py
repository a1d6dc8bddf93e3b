"""Minimize the 2-D Rosenbrock function with Hessian curvature
(the analog of reference examples/run_rosenbrock.py).

Runs on the CUDA card; ``--cpu`` runs it on the CPU."""

import torch
from example_utils import get_device, report

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import rosenbrock_problem

if __name__ == "__main__":
    device = get_device()
    print(f"Running Rosenbrock on {device}")
    params, fns = rosenbrock_problem(init=(-0.5, 1.5), device=device)
    opt = HessianFree(
        params,
        loss_fn=fns.loss_fn,
        curvature_opt="hessian",  # the true Hessian of the target function
        damping=0.5,
        cg_max_iter=50,
    )
    for step_idx in range(20):
        opt.step(None)
        report(step_idx, opt)

    final = opt.params["x"].cpu()
    print(f"\nfinal params = {final.tolist()}  (minimum is [1, 1])")
    if not torch.allclose(final, torch.ones(2), atol=1e-3):
        raise SystemExit("did not converge")
    print("converged.")
