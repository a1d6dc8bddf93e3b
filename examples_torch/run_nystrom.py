"""Low-rank Nystrom-preconditioned Hessian-free training.

Beyond-reference capability (the reference's only preconditioner family is
the diagonal empirical Fisher, reference preconditioners.py:37-127): deep-net
GGN spectra decay fast with a few dominant outliers, so a rank-r randomized
Nystrom eigensketch of the LIVE curvature captures exactly the directions
that dominate CG's iteration count.  This example trains three copies of the
same problem on identical batches and compares CG iterations per step:

- no preconditioner,
- Martens' diagonal empirical-Fisher ``(D + damping)^(-0.75)``,
- rank-r Nystrom ``(A + damping I)^{-1}`` approximation (refreshed each
  step; ``opt.step(batch, precond_lowrank=sketch)`` builds it in-step with
  the live damping).

The sketch costs r batched curvature matvecs -- cheap when it saves more CG
iterations than it spends, which the printout makes visible.

Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

from example_utils import generator, get_device, get_small_nn_problem

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import mlp_apply, mse_loss

RANK = 16
STEPS = 5

if __name__ == "__main__":
    device = get_device()
    print(f"Running Nystrom PCG comparison on {device}")
    params, batch = get_small_nn_problem(generator(device), N=64,
                                         sizes=(7, 32, 32, 3))

    opts = {
        name: HessianFree(
            params, model_fn=mlp_apply, loss_outer=mse_loss, damping=0.1
        )
        for name in ("none", "diag_ef", "nystrom")
    }

    print(f"{'step':>4} | {'cg iters (none / diag / nystrom)':^34} | "
          f"final losses")
    total = {name: 0 for name in opts}
    for step_idx in range(STEPS):
        losses = {}
        for name, opt in opts.items():
            if name == "diag_ef":
                diag = opt.get_preconditioner(*batch, reduction="mean")
                losses[name] = opt.step(batch, precond_diag=diag)
            elif name == "nystrom":
                sketch = opt.get_nystrom_sketch(batch, rank=RANK)
                losses[name] = opt.step(batch, precond_lowrank=sketch)
            else:
                losses[name] = opt.step(batch)
            total[name] += opt.history["num_cg_iters"][-1]
        iters = [opts[n].history["num_cg_iters"][-1]
                 for n in ("none", "diag_ef", "nystrom")]
        print(
            f"{step_idx:>4} | {iters[0]:>10} {iters[1]:>10} {iters[2]:>10}"
            f"   | " + "  ".join(f"{losses[n]:.5f}"
                                 for n in ("none", "diag_ef", "nystrom"))
        )

    print(
        f"\ntotal CG iterations: none {total['none']}, diag_ef "
        f"{total['diag_ef']}, nystrom {total['nystrom']} "
        f"(+{RANK} sketch matvecs/step)"
    )
    if total["nystrom"] < total["none"]:
        print("nystrom reduced the CG iteration count; done.")
    else:
        print("WARNING: no iteration reduction on this problem")
