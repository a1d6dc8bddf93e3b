"""Solver-state-sharded Hessian-free training over a 2-D (data x model)
mesh of ranks (the port of examples/run_sharded.py).

The batch is data-parallel over the ``data`` axis while every flat CG
vector and the iterate grid, the optimizer's largest buffers, split over
the ``model`` axis (the reference keeps the whole grid on one GPU,
reference cg.py:152-170).  ``--tp`` also splits the weights over the
model axis (tensor parallelism: each rank keeps its blocks between steps).
``--megatron`` trains a small transformer encoder under the Megatron specs
of tests/test_sharded.py (QKV and FF1 split by column, proj and FF2 by
row): each rank also computes only its heads and its feed-forward
columns, with one sum over the model axis per sub-layer.

Usage (rank 0 prints)::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_sharded.py --cpu [--tp | --megatron]
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_sharded.py --backend gloo     # two ranks sharing the card
"""

import torch
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
from pytorchhessianfree_tpu_torch.models import (
    cross_entropy_loss,
    init_transformer,
    mlp_apply,
    mse_loss,
    transformer_apply,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import (
    PartitionSpec as P,
    make_mesh,
)
from pytorchhessianfree_tpu_torch.parallel.sharded import (
    make_sharded_hf_step,
)

SIZES = (7, 16, 16, 4)
ENCODER = dict(vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               num_classes=4, max_len=16)


def megatron_specs(n_layers):
    """QKV and FF1 by column, proj and FF2 by row; the embeddings and the
    head by feature (gathered: their compute stays whole)."""
    col, row = P(None, "model"), P("model", None)
    return {"embed": P(None, "model"), "pos": P(None, "model"),
            "head": {"w": col, "b": P("model")},
            "blocks": [{"ln1": P(), "ln2": P(),
                        "qkv": {"w": col, "b": P("model")},
                        "proj": {"w": row, "b": P()},
                        "ff1": {"w": col, "b": P("model")},
                        "ff2": {"w": row, "b": P()}}
                       for _ in range(n_layers)]}


def encoder_batch(gen, N=32):
    """Token rows labelled by their first token, mod the class count."""
    tokens = torch.randint(0, ENCODER["vocab"], (N, ENCODER["max_len"]),
                           generator=gen, device=gen.device)
    return tokens, tokens[:, 0] % ENCODER["num_classes"]


if __name__ == "__main__":
    import sys

    rank, world, device, say = start_ranks(get_device())
    mesh = make_mesh(axis_names=("data", "model"))
    shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    say(f"Running sharded HF on {world} rank(s) on {device.type}, mesh "
        f"{shape}")

    # the same seed on every rank: the same weights and global batches
    gen = torch.Generator(device=device).manual_seed(0)
    megatron = "--megatron" in sys.argv
    if megatron:
        params = init_transformer(gen, **ENCODER)
        fns = HFModelFns(
            model_fn=lambda p, x: transformer_apply(
                p, x, n_heads=ENCODER["n_heads"]),
            loss_outer=cross_entropy_loss)

        def next_batch():
            return encoder_batch(gen)
    else:
        params, _ = get_small_nn_problem(gen, N=32, sizes=SIZES)
        fns = HFModelFns(model_fn=mlp_apply, loss_outer=mse_loss)

        def next_batch():
            return get_small_nn_problem(gen, N=32, sizes=SIZES)[1]
    config = HFConfig(damping=0.5, cg_max_iter=50)
    # the model-axis size must divide the padded flat dimension
    ravel = TrainableRavel(params, pad_to_multiple=64)

    param_specs = None
    if megatron:
        param_specs = megatron_specs(ENCODER["n_layers"])
        say("transformer blocks split Megatron-style over the model axis")
    elif "--tp" in sys.argv:
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
        params, state, stats = step(params, state, next_batch())
        losses.append(float(stats.final_loss))
        iters.append(stats.num_cg_iters)
        say(f"step {i}: loss {float(stats.init_loss):.6f} -> "
            f"{float(stats.final_loss):.6f} | cg {stats.num_cg_iters} "
            f"| damping {float(stats.damping):.4f}")

    say(f"warm start: this rank's block of {tuple(state.x0.shape)} of "
        f"{ravel.dim}")
    if megatron:
        blk, m = params["blocks"][0], shape["model"]
        say(f"block-0 qkv and proj weights on this rank: "
            f"{tuple(blk['qkv']['w'].shape)}, "
            f"{tuple(blk['proj']['w'].shape)}")
        say(f"each rank computes {ENCODER['n_heads'] // m} of "
            f"{ENCODER['n_heads']} heads and {ENCODER['d_ff'] // m} of "
            f"{ENCODER['d_ff']} feed-forward columns per block")
    else:
        say(f"layer-0 weight on this rank: "
            f"{tuple(params['layers'][0]['w'].shape)}")
    assert all(map(torch.isfinite, map(torch.tensor, losses)))
    report_launches(rank, world, iters, device, say)
    say("done.")
