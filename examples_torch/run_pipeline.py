"""End-to-end pipeline: every runtime piece composing.

C++ prefetch loader (shuffled batch assembly on background threads, native
int labels) -> DevicePrefetcher (pinned host copy and an asynchronous
transfer on a side CUDA stream, overlapped with the step) -> the stateful
HessianFree optimizer with in-step empirical-Fisher preconditioning.

The reference's equivalent is torch DataLoader workers + blocking
``.to(device)`` + manual get_preconditioner calls
(reference examples/run_allcnnc_cifar100_deepobs.py:55-75); here each
stage overlaps the previous one.

Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

import numpy as np
import torch
from example_utils import generator, get_device

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import (
    cross_entropy_loss,
    init_mlp,
    mlp_apply,
)
from pytorchhessianfree_tpu_torch.runtime import DevicePrefetcher, PrefetchLoader

N, DIM, CLASSES, BATCH, STEPS = 4096, 20, 5, 128, 8

if __name__ == "__main__":
    device = get_device()
    print(f"Running pipeline on {device}")
    rng = np.random.default_rng(0)

    # synthetic teacher-labeled dataset with native int32 labels
    teacher = init_mlp(torch.Generator().manual_seed(1),
                       sizes=(DIM, 32, 32, CLASSES))
    inputs = rng.standard_normal((N, DIM)).astype(np.float32)
    with torch.no_grad():
        labels = mlp_apply(teacher, torch.from_numpy(inputs)).argmax(-1)
    labels = labels.numpy().astype(np.int32)

    loader = PrefetchLoader(
        inputs, labels, batch_size=BATCH, seed=7, depth=4, num_threads=2
    )
    print(
        f"loader: {loader.batches_per_epoch} batches/epoch, "
        f"labels dtype {labels.dtype} (no float round-trip)"
    )

    params = init_mlp(generator(device, 2), sizes=(DIM, 32, 32, CLASSES))
    opt = HessianFree(
        params,
        model_fn=mlp_apply,
        loss_outer=cross_entropy_loss,
        damping=1.0,
        cg_max_iter=30,
        precond="diag_ef",  # EF diagonal computed inside the step
    )

    with DevicePrefetcher(loader, depth=2, device=device,
                          n_batches=STEPS) as batches:
        for i, batch in enumerate(batches):
            final_loss = opt.step(batch)
            h = opt.history
            print(
                f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
                f"{final_loss:.4f} | cg {h['num_cg_iters'][-1]} "
                f"({h['cg_reasons'][-1]})"
            )

    loader.close()
    assert opt.history["init_losses"][-1] < opt.history["init_losses"][0]
    print("loss decreased through the full pipeline; done.")
