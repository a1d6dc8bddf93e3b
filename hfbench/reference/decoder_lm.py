"""GPT-2 (Radford et al. 2019, the openai-community/gpt2 architecture) in
plain PyTorch: learned token and position embeddings, pre-LN blocks of
causal multi-head attention and a tanh-GELU feed-forward, a final layer
norm, and an output head tied to the token embedding.  No dropout.

The parameter tree is the benchmark's (``families/decoder_lm.py``):
``embed [V, d]``, ``pos [T_max, d]``, ``ln_f``, and per block ``ln1``,
``qkv`` (``w [d, 3d]``: queries, keys and values side by side), ``proj``,
``ln2``, ``ff1``, ``ff2``, each dense layer ``x @ w + b``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .hf import softmax_ce_hvp


def _ln(p, x):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps=1e-5)


def _block(blk, x, n_heads):
    N, T, d = x.shape
    dh = d // n_heads
    q, k, v = (_ln(blk["ln1"], x) @ blk["qkv"]["w"]
               + blk["qkv"]["b"]).split(d, dim=-1)
    q, k, v = (t.view(N, T, n_heads, dh).transpose(1, 2) for t in (q, k, v))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    future = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
    att = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    y = (att @ v).transpose(1, 2).reshape(N, T, d)
    x = x + y @ blk["proj"]["w"] + blk["proj"]["b"]
    h = F.gelu(_ln(blk["ln2"], x) @ blk["ff1"]["w"] + blk["ff1"]["b"],
               approximate="tanh")
    return x + h @ blk["ff2"]["w"] + blk["ff2"]["b"]


def outputs(params, tokens, model):
    """Logits ``[N, T, V]``; position t scores token t + 1."""
    x = params["embed"][tokens] + params["pos"][: tokens.shape[1]]
    for blk in params["blocks"]:
        x = _block(blk, x, model["n_heads"])
    return _ln(params["ln_f"], x) @ params["embed"].T


def outer_loss(logits, tokens):
    """Mean next-token cross-entropy over the ``N (T - 1)`` predictions."""
    V = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, V),
                           tokens[:, 1:].reshape(-1))


def outer_hvp(logits, tokens, u):
    """The loss's Hessian in the logits applied to ``u``: the last
    position predicts nothing."""
    N, T, _ = logits.shape
    out = torch.zeros_like(u)
    out[:, :-1] = softmax_ce_hvp(logits[:, :-1], u[:, :-1], N * (T - 1))
    return out


def regularizer(model):
    """No parameter-only loss term."""
    return None
