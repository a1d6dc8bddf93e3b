"""Minimal working example: the Hessian-free optimizer on a small MLP and
dummy data (the analog of reference examples/run_mwe.py).

Runs on the CUDA card; ``--cpu`` runs it on the CPU."""

import torch
from example_utils import generator, get_device, report

from pytorchhessianfree_tpu_torch import HessianFree

BATCH_SIZE = 16
DIM = 10

if __name__ == "__main__":
    device = get_device()
    print(f"Running MWE on {device}")
    gen = generator(device)

    # Model: Linear(10->10, no bias) -> ReLU -> Linear(10->10), MSE loss.
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    params = {
        "w1": randn(DIM, DIM) / DIM**0.5,
        "l2": {"w": randn(DIM, DIM) / DIM**0.5,
               "b": torch.zeros(DIM, device=device)},
    }

    def model_fn(p, x):
        h = torch.relu(x @ p["w1"])
        return h @ p["l2"]["w"] + p["l2"]["b"]

    def mse(outputs, targets):
        return torch.mean((outputs - targets) ** 2)

    opt = HessianFree(params, model_fn=model_fn, loss_outer=mse)

    for step_idx in range(5):
        inputs = torch.rand((BATCH_SIZE, DIM), generator=gen, device=device)
        targets = torch.rand((BATCH_SIZE, DIM), generator=gen, device=device)
        opt.step((inputs, targets))
        report(step_idx, opt)
    h = opt.history
    assert h["final_losses"][-1] < h["init_losses"][0], "loss did not drop"
    print("loss decreased; done.")
