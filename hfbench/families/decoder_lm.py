"""Decoder-only language models of the GPT-2 kind through the port's
``decoder_lm_apply`` and ``next_token_loss``.

A configuration's ``model`` holds ``vocab``, ``d_model``, ``n_heads``,
``n_layers``, ``d_ff``, ``max_len`` and the Zipf exponent ``zipf_s`` of the
token draw; a cell's traffic holds ``seq_len``."""

from __future__ import annotations

import functools
import math

import torch


def _shapes(model):
    """``(path, shape, kind)`` of every leaf; kind is how it is drawn."""
    V, d, dff = model["vocab"], model["d_model"], model["d_ff"]
    out = [("embed", (V, d), "embed"), ("pos", (model["max_len"], d), "pos")]
    for i in range(model["n_layers"]):
        for name, n_in, n_out in (("qkv", d, 3 * d), ("proj", d, d),
                                  ("ff1", d, dff), ("ff2", dff, d)):
            out += [(f"blocks.{i}.{name}.w", (n_in, n_out), "dense"),
                    (f"blocks.{i}.{name}.b", (n_out,), "zeros")]
        for ln in ("ln1", "ln2"):
            out += [(f"blocks.{i}.{ln}.scale", (d,), "ones"),
                    (f"blocks.{i}.{ln}.bias", (d,), "zeros")]
    out += [("ln_f.scale", (d,), "ones"), ("ln_f.bias", (d,), "zeros")]
    return out


def parameter_count(model) -> int:
    return sum(math.prod(s) for _, s, _ in _shapes(model))


def make_params(model, generator, device, dtype=torch.float32):
    """The port's initialisation (``init_decoder_lm``): dense kernels
    N(0, 1 / fan_in), token embeddings N(0, 0.01), positions N(0, 4e-4),
    zero biases, unit layer-norm scales.  Every random leaf is cut from one
    normal draw on the device."""
    shapes = _shapes(model)
    drawn = [s for _, s, kind in shapes if kind in ("embed", "pos", "dense")]
    pool = torch.randn(sum(math.prod(s) for s in drawn), generator=generator,
                       device=device, dtype=dtype)
    tree, at = {"blocks": [{} for _ in range(model["n_layers"])]}, 0
    for path, shape, kind in shapes:
        if kind in ("zeros", "ones"):
            leaf = (torch.zeros if kind == "zeros" else torch.ones)(
                shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            scale = {"embed": 0.1, "pos": 0.02,
                     "dense": 1 / math.sqrt(shape[0])}[kind]
            leaf = pool[at:at + n].view(shape) * scale
            at += n
        node, keys = tree, path.split(".")
        for k in keys[:-1]:
            node = node[int(k)] if k.isdigit() else node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def program_fns(model):
    """``HessianFree``'s model and loss callables."""
    from pytorchhessianfree_tpu_torch import models

    return dict(model_fn=functools.partial(models.decoder_lm_apply,
                                           n_heads=model["n_heads"]),
                loss_outer=models.next_token_loss, loss_reg=None)


def make_rows(model, traffic, rows, generator, device):
    """``rows`` sequences of ``seq_len`` tokens drawn i.i.d. from a Zipf law
    over the vocabulary (rank r has weight ``1 / (r + 1)^s``); inputs and
    targets are the same tokens."""
    V, T = model["vocab"], traffic["seq_len"]
    weights = 1.0 / torch.arange(1, V + 1, device=device,
                                 dtype=torch.float64) ** model["zipf_s"]
    tokens = torch.multinomial(weights, rows * T, replacement=True,
                               generator=generator).view(rows, T)
    return tokens, tokens


def forward_flops(model, traffic, rows) -> int:
    """Multiply-adds of one forward over ``rows`` sequences, counted as 2
    per product: the blocks' dense layers, the attention scores and their
    weighted sum over all ``T x T`` pairs (the causal mask is applied to a
    full product), and the tied head."""
    d, dff, V, L = (model["d_model"], model["d_ff"], model["vocab"],
                    model["n_layers"])
    T = traffic["seq_len"]
    dense = L * 2 * (d * 3 * d + d * d + 2 * d * dff) + 2 * d * V
    attention = L * 2 * 2 * T * T * d
    return rows * (T * dense + attention)
