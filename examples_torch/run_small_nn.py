"""Small NN with empirical-Fisher preconditioning and optimizer-state
inspection (the analog of reference examples/run_small_nn.py, which also
demonstrates reading the state_dict).

Runs on the CUDA card; ``--cpu`` runs it on the CPU."""

import torch
from example_utils import (
    generator,
    get_device,
    get_small_nn_batch,
    get_small_nn_problem,
    report,
)

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import mlp_apply, mse_loss

if __name__ == "__main__":
    device = get_device()
    print(f"Running small NN on {device}")
    gen = generator(device)
    params, _ = get_small_nn_problem(gen)
    opt = HessianFree(
        params, model_fn=mlp_apply, loss_outer=mse_loss, damping=0.1
    )

    for step_idx in range(3):
        batch = get_small_nn_batch(gen)
        # Martens' (D + damping)^(-0.75) empirical-Fisher preconditioner,
        # rebuilt per step on the current batch.
        diag = opt.get_preconditioner(*batch, reduction="mean")
        opt.step(batch, precond_diag=diag)
        report(step_idx, opt)

    # Inspect the optimizer state (reference examples/run_small_nn.py:46-52).
    sd = opt.state_dict()
    print("\nstate_dict:")
    print("  step_count   =", sd["step_count"])
    print("  damping      =", float(sd["state"]["damping"]))
    print("  x0 norm      =", float(torch.linalg.vector_norm(sd["state"]["x0"])))
    for k, v in sd["history"].items():
        print(f"  {k:15s} = {v}")
