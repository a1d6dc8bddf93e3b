"""All-CNN-C on (synthetic) CIFAR-100 with L2-regularized cross-entropy,
optionally data-parallel over the ranks of a process group
(the analog of reference examples/run_allcnnc_cifar100_deepobs.py; the
reference's sequential acc_step becomes data parallelism here).

Usage:
    python run_allcnnc_cifar100.py          # on the CUDA card
    python run_allcnnc_cifar100.py --cpu --tiny   # on the CPU, narrow
    python run_allcnnc_cifar100.py --data <dir>   # real CIFAR-100 from
        # <dir>/train_x.npy (float32 [N,32,32,3], DeepOBS-standardized) +
        # <dir>/train_y.npy (int [N])
    python -m torch.distributed.run --standalone --nproc-per-node N \\
        run_allcnnc_cifar100.py --dp [--backend gloo] [--cpu --tiny]
        # data-parallel over N ranks: each takes its 32 rows (8 with
        # --tiny) of every global batch; NCCL on the cards by default,
        # gloo on the CPU or where asked for (several ranks on one card)

Under ``--dp`` rank 0 prints the steps and, on the card, every rank's
kernel launches, gathered by one ``all_reduce``.
"""

import sys
import time

import torch
from example_utils import (
    flag_value,
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
    fused_cg_update,
    init_state,
    make_hf_step,
)
from pytorchhessianfree_tpu_torch.models import (
    allcnnc_apply,
    cross_entropy_loss,
    init_allcnnc,
    l2_regularizer,
)

if __name__ == "__main__":
    data_parallel = "--dp" in sys.argv
    device = get_device()
    rank, world = 0, 1
    if data_parallel:
        import torch.distributed as dist

        from pytorchhessianfree_tpu_torch.parallel.data_parallel import (
            make_dp_hf_step,
        )
        from pytorchhessianfree_tpu_torch.parallel.distributed import (
            initialize_distributed,
            rank_device,
        )
        from pytorchhessianfree_tpu_torch.parallel.mesh import (
            batch_sharding,
            make_mesh,
            shard_batch,
        )

        initialize_distributed(backend=flag_value("--backend"),
                               device=device.type)
        mesh = make_mesh()
        device = rank_device()
        rank, world = dist.get_rank(), dist.get_world_size()
    tiny = is_tiny()

    def say(text):
        if rank == 0:
            print(text, flush=True)

    say(f"Running All-CNN-C/CIFAR-100 on {device}"
        f"{f', {world} data-parallel ranks' if data_parallel else ''}"
        f"{' (tiny config)' if tiny else ''}")
    # the same seed on every rank: the same weights and global batches
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
    if data_parallel:
        step = make_dp_hf_step(fns, config, ravel, mesh)
    else:
        step = make_hf_step(fns, config, ravel)
    batch_size = (8 if tiny else 32) * world

    data_dir = parse_data_dir()
    stream = (
        real_batch_stream(data_dir, batch_size, device,
                          sharding=batch_sharding(mesh) if data_parallel
                          else None)
        if data_dir else None
    )
    if data_dir:
        say(f"streaming real data from {data_dir}")

    fused_cg_update.launches = 0
    iters = []
    try:
        for step_idx in range(2):
            if stream is not None:
                batch = next(stream)
            else:
                batch = synthetic_cifar100_batch(gen, batch_size=batch_size)
                if data_parallel:
                    batch = shard_batch(batch, mesh)
            t0 = time.perf_counter()
            params, state, stats = step(params, state, batch)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            iters.append(int(stats.num_cg_iters))
            say(
                f"step {step_idx}: loss {float(stats.init_loss):.4f} -> "
                f"{float(stats.final_loss):.4f} | cg "
                f"{int(stats.num_cg_iters)} | "
                f"lr {float(stats.lr):.4f} | {dt:.2f}s"
            )
    finally:
        if stream is not None:
            stream.close()
    if device.type == "cuda":
        # rank 0 prints every rank's count: the launcher merges the ranks'
        # output streams, which may split one rank's line with another's
        counts = torch.zeros(world, 1 + len(iters), dtype=torch.float64,
                             device=device)
        counts[rank] = torch.tensor([fused_cg_update.launches, *iters],
                                    dtype=torch.float64)
        if data_parallel:
            dist.all_reduce(counts)
        for r, row in enumerate(counts.tolist()):
            say(f"rank {r}: fused_cg_update launches: {int(row[0])} "
                f"(CG iterations {[int(i) for i in row[1:]]})")
    if data_parallel:
        dist.destroy_process_group()
