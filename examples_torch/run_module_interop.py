"""Hessian-free training of a ``torch.nn.Module`` (the interop on-ramp; the
counterpart of the JAX package's run_flax_interop.py).

The reference takes any ``torch.nn.Module`` + loss closure (reference
optimizer.py:126-154); ``interop.module_fns`` wraps one for the optimizer
with the two hard cases wired correctly:

- BatchNorm running statistics (buffers) ride IN THE BATCH
  (``buffers_in_batch=True``): frozen inside each step (CG's determinism
  contract -- the principled version of the reference's "call model.eval()"
  advice), refreshed between steps with ``module_state_update``.
- Dropout draws its masks from a seed in the batch (``rng_in_batch=True``):
  one seed per step, so the gradient, every CG matvec and every trial
  forward see the same masks; the seed advances between steps like data.

The module is in training mode (dropout active) with its BatchNorm in eval
mode (running statistics, frozen within a step); a BatchNorm left in
training mode would update its statistics inside the step, and the adapter
refuses it.

Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

import torch
from example_utils import generator, get_device
from torch import nn

from pytorchhessianfree_tpu_torch import (
    HessianFree,
    module_fns,
    module_state_update,
    split_module_state,
)
from pytorchhessianfree_tpu_torch.models import cross_entropy_loss

BATCH, D_IN, CLASSES = 64, 20, 4


def make_batch(gen, centers):
    """Points around one of ``CLASSES`` fixed centers, labeled by it."""
    dev = gen.device
    labels = torch.randint(0, CLASSES, (BATCH,), generator=gen, device=dev)
    noise = torch.randn((BATCH, D_IN), generator=gen, device=dev)
    return centers[labels] + 0.3 * noise, labels


if __name__ == "__main__":
    device = get_device()
    print(f"Running nn.Module interop HF on {device}")
    torch.manual_seed(0)  # nn.Linear's own initialization
    net = nn.Sequential(
        nn.Linear(D_IN, 32),
        nn.BatchNorm1d(32),
        nn.Tanh(),
        nn.Dropout(0.1),
        nn.Linear(32, CLASSES),
    ).to(device)
    net.train()  # dropout active ...
    net[1].eval()  # ... BatchNorm on its running statistics
    params, buffers = split_module_state(net)
    print(f"parameters {sorted(params)}, buffers {sorted(buffers)}")

    # buffers AND the dropout seed ride in the batch: inputs = (x, seed, buf)
    fns = module_fns(
        net, cross_entropy_loss, buffers_in_batch=True, rng_in_batch=True
    )
    opt = HessianFree(
        params,
        model_fn=fns.model_fn,
        loss_outer=fns.loss_outer,
        damping=1.0,
        cg_max_iter=30,
    )

    gen = generator(device)
    centers = torch.randn((CLASSES, D_IN), generator=generator(device, 42),
                          device=device)
    for i in range(6):
        x, y = make_batch(gen, centers)
        seed = 1000 + i
        opt.step(((x, seed, buffers), y))
        # refresh the running statistics BETWEEN steps (one training-mode
        # forward on copies of the buffers; the module is left as it was)
        buffers = module_state_update(net, opt.params, buffers, x, seed=seed)
        h = opt.history
        print(
            f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
            f"{h['final_losses'][-1]:.4f} | cg {h['num_cg_iters'][-1]} "
            f"({h['cg_reasons'][-1]}) | damping {h['dampings'][-1]:.3f}"
        )

    assert opt.history["init_losses"][-1] < opt.history["init_losses"][0]
    assert float(buffers["1.running_mean"].abs().sum()) > 0.0
    assert float(net[1].running_mean.abs().sum()) == 0.0  # module untouched
    print("loss decreased; BatchNorm statistics tracked; done.")
