"""Transformer encoder classifier and causal decoder LM (port of
:mod:`pytorchhessianfree_tpu.models.transformer`).

Plain functions on parameter trees with the JAX package's names and layout:
``blocks`` is a list of per-layer dicts, each key sorted as
``jax.tree_util`` sorts it, so :class:`~.utils.flatten.TrainableRavel`
gives the JAX flat order and
:func:`~pytorchhessianfree_tpu_torch.convert.params_from_jax` carries
weights across.  Deterministic (no dropout), so CG's fixed quadratic model
holds.

The numerics follow the JAX model: pre-LN blocks, population-variance
layernorm with ``rsqrt(var + 1e-5)``, tanh-approximated GELU (the default
of ``jax.nn.gelu``), attention scores accumulated in at least f32, cast
back to the activations' dtype and then divided by ``sqrt(d_head)`` taken
in that dtype, and a
``-1e30`` causal mask against global row indices.  Attention is plain
PyTorch (two matmuls and a masked softmax), as JAX computes it outside any
Pallas kernel; ``attn_chunk`` row-blocks it with each block rematerialized,
so the ``[T, T]`` probabilities are never alive at once.

``scan_layers`` is a layout knob of the JAX package (it stacks the blocks'
weights for one ``lax.scan``); PyTorch loops over the blocks either way, with
the same numbers, so it is accepted and otherwise ignored.  ``remat=True``
wraps each block in :func:`~.utils.remat.checkpoint`.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..utils.remat import checkpoint


def _normal(generator, shape, dtype, device):
    t = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=dtype)
    return t.to(device)


def _dense(generator, n_in, n_out, dtype, device):
    return {
        "w": _normal(generator, (n_in, n_out), dtype, device) / math.sqrt(n_in),
        "b": torch.zeros((n_out,), dtype=dtype, device=device),
    }


def _apply_dense(p, x):
    return x @ p["w"] + p["b"]


def _layernorm(p, x, eps=1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _ln_init(d, dtype, device):
    return {
        "scale": torch.ones((d,), dtype=dtype, device=device),
        "bias": torch.zeros((d,), dtype=dtype, device=device),
    }


def _one_hot(idx, k, dtype):
    """``idx`` [...] integers -> [..., k] 0/1 of ``dtype``, by comparison
    (no range check on the data, which a trace could not read)."""
    return (idx[..., None] == torch.arange(k, device=idx.device)).to(dtype)


def _embed(params, tokens, onehot: bool):
    """Token embedding: a row gather, or the gather-free one-hot matmul.

    ``onehot=True`` computes ``one_hot(tokens) @ embed``: the same values
    in every dtype (exact 0/1 selections), expressed as a matmul.  In the
    JAX package it is the knob for tokens sharded along two axes."""
    if onehot:
        oh = _one_hot(tokens, params["embed"].shape[0], params["embed"].dtype)
        return oh @ params["embed"]
    return params["embed"][tokens]


def init_transformer(
    generator: torch.Generator,
    vocab: int = 64,
    d_model: int = 32,
    n_heads: int = 4,
    n_layers: int = 2,
    d_ff: int = 64,
    num_classes: int = 4,
    max_len: int = 16,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """Token-classifier encoder: embed + pos -> [attn + MLP blocks] ->
    mean-pool -> linear head.  Drawn on the generator's device, which is
    also where the tensors stay."""
    del n_heads  # the head count is an argument of the apply functions
    device = generator.device
    params = {
        "embed": _normal(generator, (vocab, d_model), dtype, device) * 0.1,
        "pos": _normal(generator, (max_len, d_model), dtype, device) * 0.02,
        "blocks": [],
        "head": _dense(generator, d_model, num_classes, dtype, device),
    }
    for _ in range(n_layers):
        params["blocks"].append(
            {
                "ln1": _ln_init(d_model, dtype, device),
                "qkv": _dense(generator, d_model, 3 * d_model, dtype, device),
                "proj": _dense(generator, d_model, d_model, dtype, device),
                "ln2": _ln_init(d_model, dtype, device),
                "ff1": _dense(generator, d_model, d_ff, dtype, device),
                "ff2": _dense(generator, d_ff, d_model, dtype, device),
            }
        )
    return params


def _attend(q, k, v, causal: bool, q_offset: int = 0):
    """Softmax attention for a (chunk of) queries against all keys.

    ``q``: [N, H, Tq, dh]; ``k``/``v``: [N, H, Tk, dh] -> [N, H, Tq, dh].
    ``q_offset`` is the global position of q's first row."""
    d_head = q.shape[-1]
    # scores accumulate in >= f32 (bf16 products are exact in f32), round
    # to q's dtype, and are divided by sqrt(d_head) taken in that dtype, as
    # in the JAX model
    acc = torch.promote_types(q.dtype, torch.float32)
    scores = (q.to(acc) @ k.to(acc).transpose(-2, -1)).to(q.dtype)
    scores = scores / torch.sqrt(scores.new_tensor(float(d_head)))
    if causal:
        Tq, Tk = scores.shape[-2], scores.shape[-1]
        rows = q_offset + torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, scores.new_tensor(-1e30))
    attn = torch.softmax(scores, dim=-1)
    return attn @ v


def _chunked_attention(q, k, v, causal: bool, chunk: int):
    """Query-chunked attention: row blocks of the score matrix, each block
    rematerialized, so the [T, T] probabilities are never alive at once in
    the forward, backward or curvature passes.  The same numbers as full
    attention (softmax rows are independent)."""
    T = q.shape[2]
    n_chunks, rem = divmod(T, chunk)
    if rem:
        raise ValueError(
            f"attn_chunk={chunk} must divide the sequence length {T}"
        )
    outs = [
        checkpoint(partial(_attend, causal=causal, q_offset=i * chunk))(
            q[:, :, i * chunk:(i + 1) * chunk], k, v
        )
        for i in range(n_chunks)
    ]
    return torch.cat(outs, dim=2)


def _attention_sublayer(blk, x, n_heads: int, causal: bool, attn_chunk):
    """Pre-LN multi-head attention with residual: [N, T, d] -> [N, T, d].
    Shared by the dense block and the MoE block (:mod:`.moe`)."""
    N, T, d_model = x.shape
    d_head = d_model // n_heads

    h = _layernorm(blk["ln1"], x)
    qkv = _apply_dense(blk["qkv"], h)  # [N, T, 3*d]
    q, k, v = torch.split(qkv, d_model, dim=-1)

    def heads(t):  # [N, T, d] -> [N, H, T, d_head]
        return t.reshape(N, T, n_heads, d_head).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    if attn_chunk is not None and attn_chunk < T:
        out = _chunked_attention(q, k, v, causal, attn_chunk)
    else:
        out = _attend(q, k, v, causal)
    out = out.permute(0, 2, 1, 3).reshape(N, T, d_model)
    return x + _apply_dense(blk["proj"], out)


def _block(blk, x, n_heads: int, causal: bool = False, attn_chunk=None):
    """One pre-LN attention + MLP residual block: [N, T, d] -> [N, T, d]."""
    x = _attention_sublayer(blk, x, n_heads, causal, attn_chunk)
    h = _layernorm(blk["ln2"], x)
    h = F.gelu(_apply_dense(blk["ff1"], h), approximate="tanh")
    return x + _apply_dense(blk["ff2"], h)


def _run_blocks(
    blocks, x, n_heads, scan_layers, remat, causal=False, attn_chunk=None
):
    del scan_layers  # layout knob of the JAX package (module docstring)
    block = partial(_block, n_heads=n_heads, causal=causal,
                    attn_chunk=attn_chunk)
    if remat:
        block = checkpoint(block)
    for blk in blocks:
        x = block(blk, x)
    return x


def transformer_apply(
    params: Any,
    tokens: torch.Tensor,
    n_heads: int = 4,
    scan_layers: bool = True,
    remat: bool = False,
    attn_chunk: Optional[int] = None,
    embed_onehot: bool = False,
) -> torch.Tensor:
    """Forward pass.  ``tokens``: [N, T] integers -> [N, num_classes]
    logits.  ``remat=True`` rematerializes each block; ``attn_chunk``
    row-blocks the attention softmax (peak memory O(chunk x T) per layer
    instead of O(T^2), the same numbers); ``embed_onehot`` switches the
    embedding to the one-hot matmul."""
    T = tokens.shape[1]
    x = _embed(params, tokens, embed_onehot) + params["pos"][:T]
    x = _run_blocks(
        params["blocks"], x, n_heads, scan_layers, remat,
        attn_chunk=attn_chunk,
    )
    pooled = torch.mean(x, dim=1)
    return _apply_dense(params["head"], pooled)


def init_decoder_lm(
    generator: torch.Generator,
    vocab: int = 64,
    d_model: int = 32,
    n_heads: int = 4,
    n_layers: int = 2,
    d_ff: int = 64,
    max_len: int = 16,
    dtype: torch.dtype = torch.float32,
    tied_head: bool = True,
) -> Any:
    """Causal decoder LM: embed + pos -> [causal attn + MLP blocks] ->
    final LN -> per-position vocab logits.  ``tied_head=True`` reuses the
    embedding as the output projection (``x @ embed.T``)."""
    enc = init_transformer(
        generator,
        vocab=vocab,
        d_model=d_model,
        n_heads=n_heads,
        n_layers=n_layers,
        d_ff=d_ff,
        num_classes=vocab,
        max_len=max_len,
        dtype=dtype,
    )
    params = {
        "embed": enc["embed"],
        "pos": enc["pos"],
        "blocks": enc["blocks"],
        "ln_f": _ln_init(d_model, dtype, generator.device),
    }
    if not tied_head:
        params["head"] = enc["head"]
    return params


def decoder_lm_apply(
    params: Any,
    tokens: torch.Tensor,
    n_heads: int = 4,
    scan_layers: bool = True,
    remat: bool = False,
    attn_chunk: Optional[int] = None,
    embed_onehot: bool = False,
) -> torch.Tensor:
    """Causal forward pass.  ``tokens``: [N, T] integers -> [N, T, vocab]
    logits, position t predicting token t+1.  The knobs are those of
    :func:`transformer_apply`; with ``attn_chunk`` the causal mask is
    applied per block against global positions."""
    T = tokens.shape[1]
    x = _embed(params, tokens, embed_onehot) + params["pos"][:T]
    x = _run_blocks(
        params["blocks"], x, n_heads, scan_layers, remat, causal=True,
        attn_chunk=attn_chunk,
    )
    x = _layernorm(params["ln_f"], x)
    if "head" in params:
        return _apply_dense(params["head"], x)
    return x @ params["embed"].T


def next_token_loss(
    logits: torch.Tensor,
    tokens: torch.Tensor,
    onehot: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy: ``logits`` [N, T, V] at position t
    scored against ``tokens[:, t+1]``, averaged over the N*(T-1) positions.

    ``onehot=True`` selects the target log-probabilities by a one-hot
    contraction instead of a gather (the same values).  ``mask``: optional
    [N, T] 0/1 weights over target positions (``mask[:, t]`` weights the
    prediction of token t); the mean is then ``sum(ll * m) / max(sum(m),
    1)``.  Thread it through the batch so every phase of a step sees it."""
    pred = logits[:, :-1, :]
    tgt = tokens[:, 1:]
    logp = torch.log_softmax(pred, dim=-1)
    if onehot:
        ll = torch.sum(logp * _one_hot(tgt, logits.shape[-1], logp.dtype),
                       dim=-1)
    else:
        ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    if mask is None:
        return -torch.mean(ll)
    m = mask[:, 1:].to(ll.dtype)
    return -torch.sum(ll * m) / torch.clamp(torch.sum(m), min=1.0)
