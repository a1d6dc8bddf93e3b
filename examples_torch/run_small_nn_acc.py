"""Small NN trained with the accumulated step over per-quantity datalists,
including the reduction self-test
(the analog of reference examples/run_small_nn_acc.py).

Runs on the CUDA card; ``--cpu`` runs it on the CPU."""

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
    print(f"Running small NN (acc_step) on {device}")
    gen = generator(device)
    params, _ = get_small_nn_problem(gen, N=32)
    opt = HessianFree(
        params, model_fn=mlp_apply, loss_outer=mse_loss, damping=0.1
    )

    for step_idx in range(3):
        x, y = get_small_nn_batch(gen, N=32)

        # Independent datalists per quantity (reference optimizer.py:554-559):
        # ragged chunks for the loss, halves for gradient and curvature.
        loss_data = [(x[:10], y[:10]), (x[10:22], y[10:22]), (x[22:], y[22:])]
        grad_data = [(x[:16], y[:16]), (x[16:], y[16:])]
        mvp_data = [(x[:16], y[:16]), (x[16:], y[16:])]

        if step_idx == 0:
            # Verify the declared loss reduction before trusting it
            # (reference optimizer.py:817-926).
            opt.test_reduction(loss_data, "mean")
            print("reduction self-test passed")

        opt.acc_step(
            loss_data, grad_data=grad_data, mvp_data=mvp_data, reduction="mean"
        )
        report(step_idx, opt)
