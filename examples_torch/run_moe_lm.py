"""Hessian-free training of a Mixture-of-Experts causal decoder LM.

Top-2 routed experts with per-expert capacity (GShard-style einsum
dispatch, models/moe.py) -- the sparse-expert member of the model zoo (no
reference analog).  HF needs nothing special: routing is deterministic
given (params, batch) and the top-k masks are piecewise-constant, so the
GGN's jvp/vjp flow through the gate probabilities and expert MLPs and
CG's fixed-quadratic assumption holds.

The Switch load-balance auxiliary loss rides through ``return_aux=True``
and a composing ``loss_outer`` -- the GGN treats it as one more output
block.  Runs on the CUDA card; ``--cpu`` runs it on the CPU; ``--top1``
routes top-1, ``--groups S`` routes in S router groups; ``--tiny`` runs 4
steps on batches of 8 (the loss must fall, not halve).

``--ep`` runs EXPERT-PARALLEL over the ranks of a process group: the
expert weight stacks split over the mesh's model axis
(``moe_param_specs``) through ``HessianFree(mesh=, param_specs=)``; each
rank runs its own experts and rank 0 prints::

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        run_moe_lm.py --ep --cpu      # or --backend gloo on one card
"""

import sys

import torch
from example_utils import (
    generator,
    get_device,
    is_tiny,
    report_launches,
    start_ranks,
)

from pytorchhessianfree_tpu_torch import HessianFree, fused_cg_update
from pytorchhessianfree_tpu_torch.models import (
    init_moe_decoder_lm,
    moe_decoder_lm_apply,
    moe_param_specs,
    next_token_loss,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten

VOCAB, T, BATCH = 32, 16, 32
N_EXPERTS, AUX_WEIGHT = 4, 0.01
A, B = 7, 3  # affine next-token rule; gcd(A, VOCAB) = 1


def make_batch(gen):
    start = torch.randint(0, VOCAB, (8 if is_tiny() else BATCH,),
                          generator=gen,
                          device=gen.device)
    toks = [start]
    for _ in range(T - 1):
        toks.append((A * toks[-1] + B) % VOCAB)
    tokens = torch.stack(toks, dim=1)
    return tokens, tokens


if __name__ == "__main__":
    expert_parallel = "--ep" in sys.argv
    top_k = 1 if "--top1" in sys.argv else 2
    groups = (int(sys.argv[sys.argv.index("--groups") + 1])
              if "--groups" in sys.argv else 1)
    device = get_device()
    print_ = print
    mesh_kw = {}
    if expert_parallel:
        from pytorchhessianfree_tpu_torch.parallel.mesh import make_mesh

        rank, world, device, print_ = start_ranks(device)
        mesh = make_mesh(axis_names=("data", "model"))
    print_(
        f"Running MoE decoder LM HF on {device.type} "
        f"(top-{top_k} routing, {groups} router group(s))"
    )
    gen = generator(device)
    params = init_moe_decoder_lm(
        gen, vocab=VOCAB, d_model=32, n_layers=2, d_ff=64,
        n_experts=N_EXPERTS, max_len=T,
    )
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    n_expert = sum(
        blk[k].numel() for blk in params["blocks"]
        for k in ("w1", "b1", "w2", "b2")
    )
    print_(
        f"MoE decoder params: {n_params} ({n_expert} in {N_EXPERTS} experts"
        f" x {len(params['blocks'])} layers, top-{top_k} routed)"
    )
    if expert_parallel:
        mesh_kw = dict(mesh=mesh,
                       param_specs=moe_param_specs(len(params["blocks"])))
        print_(f"expert-parallel: experts split {mesh.size(1)}-way over "
               f"the model axis of {world} rank(s)")

    opt = HessianFree(
        params,
        model_fn=lambda p, t: moe_decoder_lm_apply(
            p, t, return_aux=True, top_k=top_k, router_groups=groups
        ),
        loss_outer=lambda out, t: next_token_loss(out[0], t)
        + AUX_WEIGHT * out[1],
        damping=1.0,
        cg_max_iter=30,
        **mesh_kw,
    )

    steps = 4 if is_tiny() else 8
    fused_cg_update.launches = 0
    for i in range(steps):
        opt.step(make_batch(gen))
        h = opt.history
        print_(
            f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
            f"{h['final_losses'][-1]:.4f} | cg {h['num_cg_iters'][-1]} "
            f"({h['cg_reasons'][-1]}) | damping {h['dampings'][-1]:.3f}"
        )

    assert opt.history["final_losses"][-1] < (
        (1.0 if is_tiny() else 0.5) * opt.history["init_losses"][0]
    )
    # balanced routing: the aux loss at the trained params should be near
    # its optimum E * sum(1/E * 1/E) = 1 for uniform routing
    with torch.no_grad():
        _, aux = moe_decoder_lm_apply(
            opt.params, make_batch(gen)[0], return_aux=True, top_k=top_k,
            router_groups=groups,
        )
    if expert_parallel:
        report_launches(rank, world, opt.history["num_cg_iters"], device,
                        print_)
    print_(f"load-balance aux at trained params: {float(aux):.3f} "
           "(1.0 = perfectly uniform)")
    print_(f"next-token loss {'down' if is_tiny() else 'halved'} through "
           "routed experts; done.")
