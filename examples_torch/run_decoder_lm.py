"""Hessian-free training of a causal decoder language model.

Next-token cross-entropy over the WHOLE sequence (a softmax GGN block at
every position), through strictly causal attention -- the workload where
the sequence axis does real second-order work, beyond the encoder
classifier's single pooled label.  Task: an affine next-token rule
tok[t+1] = (a*tok[t] + b) mod V, fully learnable, init loss ~ ln(V).

Runs on the CUDA card; ``--cpu`` runs it on the CPU.  ``--chunk N``
row-blocks the attention softmax (``attn_chunk``): the same numbers, with
O(chunk x T) live attention memory.
"""

import math
import sys

import torch
from example_utils import generator, get_device

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import (
    decoder_lm_apply,
    init_decoder_lm,
    next_token_loss,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten

VOCAB, T, BATCH = 32, 16, 32
A, B = 7, 3  # gcd(A, VOCAB) = 1 -> the rule is a permutation


def make_batch(gen):
    start = torch.randint(0, VOCAB, (BATCH,), generator=gen,
                          device=gen.device)
    toks = [start]
    for _ in range(T - 1):
        toks.append((A * toks[-1] + B) % VOCAB)
    tokens = torch.stack(toks, dim=1)
    return tokens, tokens  # the loss reads the raw tokens as targets


if __name__ == "__main__":
    attn_chunk = None
    if "--chunk" in sys.argv:
        attn_chunk = int(sys.argv[sys.argv.index("--chunk") + 1])
    device = get_device()
    print(f"Running decoder LM HF on {device}"
          + (f" (attn_chunk={attn_chunk})" if attn_chunk else ""))
    gen = generator(device)
    params = init_decoder_lm(
        gen, vocab=VOCAB, d_model=32, n_layers=2, d_ff=64, max_len=T
    )
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    print(f"decoder LM params: {n_params} (tied embedding head), "
          f"init loss ~ ln({VOCAB}) = {math.log(VOCAB):.3f}")

    opt = HessianFree(
        params,
        model_fn=lambda p, toks: decoder_lm_apply(
            p, toks, n_heads=4, attn_chunk=attn_chunk
        ),
        loss_outer=next_token_loss,
        damping=1.0,
        cg_max_iter=30,
    )

    for i in range(8):
        opt.step(make_batch(gen))
        h = opt.history
        print(
            f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
            f"{h['final_losses'][-1]:.4f} | cg {h['num_cg_iters'][-1]} "
            f"({h['cg_reasons'][-1]}) | damping {h['dampings'][-1]:.3f}"
        )

    assert opt.history["final_losses"][-1] < (
        0.5 * opt.history["init_losses"][0]
    )
    print("next-token loss halved; done.")
