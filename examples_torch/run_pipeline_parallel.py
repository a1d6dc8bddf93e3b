"""Hessian-free training THROUGH a pipeline-parallel model (the port of
examples/run_pipeline_parallel.py).

The decoder's blocks run as a GPipe microbatch schedule over a 4-stage
mesh axis of ranks (``parallel/pipeline.py``): each stage holds L/S
consecutive layers, and activations flow from stage to stage through
``ppermute``.  Because the schedule is differentiable dataflow, the SAME
pipelined callable serves the HF gradient, the GGN jvp/vjp inside CG, and
every backtracking and line-search trial forward -- the optimizer does not
know the model is pipelined, and every rank runs the plain
``HessianFree`` on it.

Usage (4 ranks, one per stage; rank 0 prints)::

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        run_pipeline_parallel.py --cpu
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        run_pipeline_parallel.py --backend gloo   # four ranks on one card
"""

import torch
from example_utils import get_device, report_launches, start_ranks

from pytorchhessianfree_tpu_torch import HessianFree, fused_cg_update
from pytorchhessianfree_tpu_torch.models import (
    init_decoder_lm,
    next_token_loss,
)
from pytorchhessianfree_tpu_torch.models.transformer import (
    _block,
    _layernorm,
    stack_blocks,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import make_mesh
from pytorchhessianfree_tpu_torch.parallel.pipeline import pipeline_blocks

VOCAB, T, BATCH = 32, 16, 8
N_LAYERS, N_HEADS, STAGES, MICRO = 4, 4, 4, 2
A, B = 7, 3


def make_batch(gen):
    start = torch.randint(0, VOCAB, (BATCH,), generator=gen,
                          device=gen.device)
    toks = [start]
    for _ in range(T - 1):
        toks.append((A * toks[-1] + B) % VOCAB)
    tokens = torch.stack(toks, dim=1)
    return tokens, tokens


if __name__ == "__main__":
    rank, world, device, say = start_ranks(get_device())
    if world != STAGES:
        raise SystemExit(f"{world} rank(s); start {STAGES}, one per stage "
                         f"(--nproc-per-node {STAGES})")
    mesh = make_mesh(STAGES, axis_names=("stage",))
    say(f"Pipeline-parallel decoder LM on {device.type}: {N_LAYERS} layers "
        f"over {STAGES} stages, {MICRO} microbatches (bubble "
        f"{(STAGES - 1) / (MICRO + STAGES - 1):.0%} per pass)")

    # the same seed on every rank: the same weights and batches
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_decoder_lm(gen, vocab=VOCAB, d_model=32,
                             n_layers=N_LAYERS, d_ff=64, max_len=T)

    def model_fn(p, tokens):
        x = p["embed"][tokens] + p["pos"][:T]
        x = pipeline_blocks(
            stack_blocks(p["blocks"]), x,
            lambda blk, h: _block(blk, h, N_HEADS, causal=True),
            mesh, n_microbatches=MICRO,
        )
        x = _layernorm(p["ln_f"], x)
        return x @ p["embed"].T

    opt = HessianFree(params, model_fn=model_fn, loss_outer=next_token_loss,
                      damping=1.0, cg_max_iter=20)
    fused_cg_update.launches = 0
    for i in range(6):
        opt.step(make_batch(gen))
        h = opt.history
        say(f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
            f"{h['final_losses'][-1]:.4f} | cg {h['num_cg_iters'][-1]} "
            f"({h['cg_reasons'][-1]})")
    assert opt.history["final_losses"][-1] < (
        0.5 * opt.history["init_losses"][0]
    )
    report_launches(rank, world, opt.history["num_cg_iters"], device, say)
    say("next-token loss halved through the pipelined model; done.")
