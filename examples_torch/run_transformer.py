"""Hessian-free training of a Transformer encoder classifier.

Beyond the reference's model zoo (MLPs and CNNs only,
reference examples/): the same HF pipeline -- GGN through softmax attention
and layernorm, CG with Martens' criterion, LM damping, CG-backtracking,
Armijo line search -- trains an attention model unchanged.  The task is a
learnable synthetic one (classify a sequence by which token dominates it),
so the loss visibly drops in a few steps.

Runs on the CUDA card; ``--cpu`` runs it on the CPU.
"""

import torch
from example_utils import generator, get_device

from pytorchhessianfree_tpu_torch import HessianFree
from pytorchhessianfree_tpu_torch.models import (
    cross_entropy_loss,
    init_transformer,
    transformer_apply,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten

VOCAB, T, CLASSES, BATCH = 16, 12, 4, 64


def make_batch(gen):
    """Sequences whose label is the majority token class (token // 4)."""
    dev = gen.device
    labels = torch.randint(0, CLASSES, (BATCH,), generator=gen, device=dev)
    # bias each sequence's tokens toward its label's token group
    base = torch.randint(0, VOCAB, (BATCH, T), generator=gen, device=dev)
    biased = labels[:, None] * 4 + torch.randint(
        0, 4, (BATCH, T), generator=gen, device=dev
    )
    mask = torch.rand((BATCH, T), generator=gen, device=dev) < 0.7
    return torch.where(mask, biased, base), labels


if __name__ == "__main__":
    device = get_device()
    print(f"Running transformer HF on {device}")
    gen = generator(device)
    params = init_transformer(
        gen, vocab=VOCAB, num_classes=CLASSES, max_len=T
    )
    n_params = sum(p.numel() for p in tree_flatten(params)[0])
    print(f"transformer params: {n_params}")

    opt = HessianFree(
        params,
        model_fn=transformer_apply,
        loss_outer=cross_entropy_loss,
        damping=1.0,
        cg_max_iter=30,
    )

    for i in range(6):
        opt.step(make_batch(gen))
        h = opt.history
        print(
            f"step {i}: loss {h['init_losses'][-1]:.4f} -> "
            f"{h['final_losses'][-1]:.4f} | cg {h['num_cg_iters'][-1]} "
            f"({h['cg_reasons'][-1]}) | damping {h['dampings'][-1]:.3f}"
        )

    assert opt.history["init_losses"][-1] < opt.history["init_losses"][0]
    print("loss decreased; done.")
