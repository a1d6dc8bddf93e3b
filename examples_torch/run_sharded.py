"""Solver-state-sharded Hessian-free training over a 2-D (data x model)
mesh of ranks (the port of examples/run_sharded.py).

The batch is data-parallel over the ``data`` axis while every flat CG
vector and the iterate grid, the optimizer's largest buffers, split over
the ``model`` axis (the reference keeps the whole grid on one GPU,
reference cg.py:152-170).  ``--tp`` also splits the weights over the
model axis (tensor parallelism: each rank keeps its blocks between steps).

Usage (rank 0 prints)::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_sharded.py --cpu [--tp]
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_sharded.py --backend gloo     # two ranks sharing the card
"""

from example_utils import (
    get_device,
    get_small_nn_problem,
    report_launches,
    start_ranks,
)

from pytorchhessianfree_tpu_torch import (
    HFConfig,
    HFModelFns,
    TrainableRavel,
    fused_cg_update,
    init_state,
)
from pytorchhessianfree_tpu_torch.models import mlp_apply, mse_loss
from pytorchhessianfree_tpu_torch.parallel.mesh import (
    PartitionSpec as P,
    make_mesh,
)
from pytorchhessianfree_tpu_torch.parallel.sharded import (
    make_sharded_hf_step,
)

SIZES = (7, 16, 16, 4)

if __name__ == "__main__":
    import sys

    import torch

    rank, world, device, say = start_ranks(get_device())
    mesh = make_mesh(axis_names=("data", "model"))
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    say(f"Running sharded HF on {world} rank(s) on {device.type}, mesh "
        f"{shape}")

    # the same seed on every rank: the same weights and global batches
    gen = torch.Generator(device=device).manual_seed(0)
    params, _ = get_small_nn_problem(gen, N=32, sizes=SIZES)
    fns = HFModelFns(model_fn=mlp_apply, loss_outer=mse_loss)
    config = HFConfig(damping=0.5, cg_max_iter=50)
    # the model-axis size must divide the padded flat dimension
    ravel = TrainableRavel(params, pad_to_multiple=64)

    param_specs = None
    if "--tp" in sys.argv:
        # tensor parallelism: output-feature dimension over the model axis
        param_specs = {"layers": [{"w": P(None, "model"), "b": P("model")}
                                  for _ in range(len(SIZES) - 1)]}
        say("weights split tensor-parallel over the model axis")

    step = make_sharded_hf_step(fns, config, ravel, mesh,
                                param_specs=param_specs)
    state = init_state(ravel, config)
    losses, iters = [], []
    fused_cg_update.launches = 0
    for i in range(4):
        _, batch = get_small_nn_problem(gen, N=32, sizes=SIZES)
        params, state, stats = step(params, state, batch)
        losses.append(float(stats.final_loss))
        iters.append(stats.num_cg_iters)
        say(f"step {i}: loss {float(stats.init_loss):.6f} -> "
            f"{float(stats.final_loss):.6f} | cg {stats.num_cg_iters} "
            f"| damping {float(stats.damping):.4f}")

    say(f"warm start: this rank's block of {tuple(state.x0.shape)} of "
        f"{ravel.dim}")
    say(f"layer-0 weight on this rank: "
        f"{tuple(params['layers'][0]['w'].shape)}")
    assert all(map(torch.isfinite, map(torch.tensor, losses)))
    report_launches(rank, world, iters, device, say)
    say("done.")
