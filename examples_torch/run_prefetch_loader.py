"""Drive training from the native C++ prefetching batch loader.

The reference feeds its workloads with torch DataLoaders
(reference examples/example_utils.py:41-56); the port's native runtime
assembles shuffled batches on background C++ threads so host-side batch
preparation overlaps the step.  Here each numpy batch is moved to the
device by hand; ``run_pipeline.py`` adds the device prefetcher.

Runs on the CUDA card; ``--cpu`` runs it on the CPU."""

import numpy as np
import torch
from example_utils import generator, get_device, report

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import init_mlp, mlp_apply, mse_loss
from pytorchhessianfree_tpu_torch.runtime import PrefetchLoader

if __name__ == "__main__":
    device = get_device()
    print(f"Running prefetch-loader demo on {device}")
    rng = np.random.default_rng(0)
    # A fixed synthetic regression dataset (the loader owns shuffling).
    X = rng.standard_normal((2048, 7)).astype(np.float32)
    W = rng.standard_normal((7, 3)).astype(np.float32)
    Y = np.tanh(X @ W) + 0.05 * rng.standard_normal((2048, 3)).astype(
        np.float32
    )

    loader = PrefetchLoader(
        X, Y, batch_size=128, seed=0, depth=4, num_threads=2
    )
    print(f"batches/epoch = {loader.batches_per_epoch}")

    params = init_mlp(generator(device))
    opt = HessianFree(
        params, model_fn=mlp_apply, loss_outer=mse_loss, damping=0.5
    )

    try:
        for step_idx in range(8):
            x, y = loader.next_batch()
            opt.step((torch.from_numpy(x).to(device),
                      torch.from_numpy(y).to(device)))
            report(step_idx, opt)
    finally:
        loader.close()
    h = opt.history
    assert h["final_losses"][-1] < h["init_losses"][0], "loss did not drop"
    print("loss decreased on loader batches; done.")
