"""ResNet-18 on MNIST with the full HF pipeline: CG with Martens' stop,
CG-backtracking and the Armijo line search
(the analog of reference examples/run_resnet18_mnist.py).

Runs on the CUDA card; ``--cpu`` runs it on the CPU, ``--tiny`` at an
eighth of the width with batch 8 and 5 CG iterations.  Data: synthetic
MNIST-shaped batches by default; ``--data <dir>`` with ``train_x.npy``
(float32 [N,28,28,1], [0,1]-scaled) + ``train_y.npy`` (int [N]) streams a
real dataset through the native loader and the device prefetcher -- the
real-MNIST analog of the reference's torchvision pipeline
(reference examples/run_resnet18_mnist.py:12-27).  On the card it runs
cuDNN's deterministic algorithms, so that the determinism self-test holds
bit for bit.

On the card it also prints how often the CG update kernel
(``fused_cg_update``) launched in the steps: once per CG iteration."""

import time

import torch
from example_utils import (
    generator,
    get_device,
    is_tiny,
    parse_data_dir,
    real_batch_stream,
    report,
    synthetic_mnist_batch,
)

from pytorchhessianfree_tpu_torch import HessianFree, fused_cg_update
from pytorchhessianfree_tpu_torch.models import (
    cross_entropy_loss,
    init_resnet18,
    resnet18_apply,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten

if __name__ == "__main__":
    device = get_device()
    if device.type == "cuda":
        # cuDNN's default convolution backward algorithms sum in an order
        # that varies from call to call: two matvecs of one vector then
        # differ in their last bits, which the determinism self-test's
        # entry-by-entry comparison reports as randomness
        torch.backends.cudnn.deterministic = True
    tiny = is_tiny()
    batch_size = 8 if tiny else 32

    print(f"Running ResNet-18/MNIST on {device}"
          f"{' (tiny config)' if tiny else ''}")
    gen = generator(device)
    params = init_resnet18(
        gen, num_classes=10, in_channels=1,
        width_scale=0.125 if tiny else 1.0,
    )
    n_params = sum(t.numel() for t in tree_flatten(params)[0])
    print(f"parameters: {n_params:,}")

    opt = HessianFree(
        params,
        model_fn=resnet18_apply,
        loss_outer=cross_entropy_loss,
        damping=1.0,
        cg_max_iter=5 if tiny else 50,  # demo budget; default is 250
    )

    data_dir = parse_data_dir()
    stream = (
        real_batch_stream(data_dir, batch_size, device) if data_dir else None
    )
    if data_dir:
        print(f"streaming real data from {data_dir}")

    fused_cg_update.launches = 0
    try:
        for step_idx in range(2):
            if stream is not None:
                batch = next(stream)
            else:
                batch = synthetic_mnist_batch(gen, batch_size=batch_size)
            if step_idx == 0:
                det = opt.test_deterministic(batch)
                print("determinism self-test:", det)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            opt.step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            report(step_idx, opt)
            print(f"         wall-clock {dt:.2f}s")
    finally:
        if stream is not None:
            stream.close()
    if device.type == "cuda":
        print(f"fused_cg_update launches: {fused_cg_update.launches} "
              f"(CG iterations {opt.history['num_cg_iters']})")
