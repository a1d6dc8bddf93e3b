"""Context-parallel Hessian-free training of the causal decoder LM (the
port of examples/run_context_parallel.py).

The sequence axis of the tokens splits over the mesh's ``model`` axis
(``batch_specs=P(None, "model")``): each rank holds T / M positions, the
attention gathers every position's keys and values over the axis, and the
next-token loss crosses the shard boundary.  The CG vector space splits
over the same axis, so both the activations and the optimizer's working
set divide across the ranks.  ``--onehot`` switches to the one-hot
embedding and loss and splits the tokens over both axes (``P("data",
"model")``); ``--tiny`` runs 3 steps (the loss must fall, not halve).

Usage (rank 0 prints)::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_context_parallel.py --cpu [--onehot]
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        run_context_parallel.py --backend gloo   # two ranks on one card
"""

import sys

import torch
from example_utils import get_device, is_tiny, report_launches, start_ranks

from pytorchhessianfree_tpu_torch import (
    HFConfig,
    HFModelFns,
    TrainableRavel,
    fused_cg_update,
    init_state,
)
from pytorchhessianfree_tpu_torch.models import (
    decoder_lm_apply,
    init_decoder_lm,
    next_token_loss,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import (
    PartitionSpec as P,
    make_mesh,
)
from pytorchhessianfree_tpu_torch.parallel.sharded import (
    make_sharded_hf_step,
)

VOCAB, T, BATCH = 32, 16, 8
A, B = 7, 3  # affine next-token rule; gcd(A, VOCAB) = 1


def make_batch(gen):
    start = torch.randint(0, VOCAB, (BATCH,), generator=gen,
                          device=gen.device)
    toks = [start]
    for _ in range(T - 1):
        toks.append((A * toks[-1] + B) % VOCAB)
    tokens = torch.stack(toks, dim=1)
    return tokens, tokens


if __name__ == "__main__":
    onehot = "--onehot" in sys.argv
    rank, world, device, say = start_ranks(get_device())
    mesh = make_mesh(axis_names=("data", "model"))
    msize = mesh.size(1)
    say(f"Context-parallel decoder LM on {world} rank(s) on {device.type}, "
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}: seq {T} "
        f"split {msize}-way" + (" (2-D one-hot layout)" if onehot else ""))

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_decoder_lm(gen, vocab=VOCAB, d_model=32, n_layers=2,
                             d_ff=64, max_len=T)
    fns = HFModelFns(
        model_fn=lambda p, t: decoder_lm_apply(p, t, n_heads=4,
                                               embed_onehot=onehot),
        loss_outer=lambda o, t: next_token_loss(o, t, onehot=onehot),
    )
    config = HFConfig(damping=1.0, cg_max_iter=30)
    ravel = TrainableRavel(params, pad_to_multiple=1024)
    spec = P("data", "model") if onehot else P(None, "model")
    step = make_sharded_hf_step(fns, config, ravel, mesh, batch_specs=spec)

    state = init_state(ravel, config)
    first = last = None
    iters = []
    fused_cg_update.launches = 0
    for i in range(3 if is_tiny() else 6):
        params, state, stats = step(params, state, make_batch(gen))
        init_l, final_l = float(stats.init_loss), float(stats.final_loss)
        first = init_l if first is None else first
        last = final_l
        iters.append(stats.num_cg_iters)
        say(f"step {i}: loss {init_l:.4f} -> {final_l:.4f} | "
            f"cg {stats.num_cg_iters} | "
            f"damping {float(stats.new_damping):.3f}")

    assert last < (1.0 if is_tiny() else 0.5) * first
    report_launches(rank, world, iters, device, say)
    say(f"warm start: this rank's block of {tuple(state.x0.shape)} of "
        f"{ravel.dim}")
    say(f"next-token loss {'down' if is_tiny() else 'halved'} under "
        "sequence splitting; done.")
