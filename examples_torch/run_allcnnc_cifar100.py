"""All-CNN-C on (synthetic) CIFAR-100 with L2-regularized cross-entropy
(the analog of reference examples/run_allcnnc_cifar100_deepobs.py).

Usage:
    python run_allcnnc_cifar100.py          # on the CUDA card
    python run_allcnnc_cifar100.py --cpu --tiny   # on the CPU, narrow
    python run_allcnnc_cifar100.py --data <dir>   # real CIFAR-100 from
        # <dir>/train_x.npy (float32 [N,32,32,3], DeepOBS-standardized) +
        # <dir>/train_y.npy (int [N])

Single card only: the JAX package's ``--dp`` (data parallelism over a
device mesh) is not ported yet and raises (ROADMAP.md, item 20).
"""

import sys
import time

import torch
from example_utils import (
    generator,
    get_device,
    is_tiny,
    parse_data_dir,
    real_batch_stream,
    synthetic_cifar100_batch,
)

from pytorchhessianfree_tpu_torch import (
    HFConfig,
    HFModelFns,
    TrainableRavel,
    init_state,
    make_hf_step,
)
from pytorchhessianfree_tpu_torch.config import not_ported
from pytorchhessianfree_tpu_torch.models import (
    allcnnc_apply,
    cross_entropy_loss,
    init_allcnnc,
    l2_regularizer,
)

if __name__ == "__main__":
    if "--dp" in sys.argv:
        raise not_ported("run_allcnnc_cifar100.py --dp", "item 20")
    device = get_device()
    tiny = is_tiny()
    print(f"Running All-CNN-C/CIFAR-100 on {device}"
          f"{' (tiny config)' if tiny else ''}")
    gen = generator(device)
    params = init_allcnnc(
        gen, num_classes=100, width_scale=0.125 if tiny else 1.0
    )

    # L2-regularized loss (DeepOBS style, reference
    # examples/run_allcnnc_cifar100_deepobs.py:23-31): loss_reg enters the
    # gradient, the LM reduction ratio, CG-backtracking and the line search,
    # while GGN curvature keeps flowing through the outputs only (an
    # additive params-only term has zero curvature through the outputs --
    # the reference's exact behavior with a regularized forward closure).
    fns = HFModelFns(
        model_fn=allcnnc_apply,
        loss_outer=cross_entropy_loss,
        loss_reg=l2_regularizer,
    )
    config = HFConfig(damping=1.0, cg_max_iter=5 if tiny else 50)
    ravel = TrainableRavel(params, pad_to_multiple=1024)
    state = init_state(ravel, config)
    step = make_hf_step(fns, config, ravel)
    batch_size = 8 if tiny else 32

    data_dir = parse_data_dir()
    stream = (
        real_batch_stream(data_dir, batch_size, device) if data_dir else None
    )
    if data_dir:
        print(f"streaming real data from {data_dir}")

    try:
        for step_idx in range(2):
            if stream is not None:
                batch = next(stream)
            else:
                batch = synthetic_cifar100_batch(gen, batch_size=batch_size)
            t0 = time.perf_counter()
            params, state, stats = step(params, state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            print(
                f"step {step_idx}: loss {float(stats.init_loss):.4f} -> "
                f"{float(stats.final_loss):.4f} | cg "
                f"{int(stats.num_cg_iters)} | "
                f"lr {float(stats.lr):.4f} | {dt:.2f}s"
            )
    finally:
        if stream is not None:
            stream.close()
