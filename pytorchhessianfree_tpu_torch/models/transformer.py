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

Context parallelism (:mod:`~..parallel.sharded` with the tokens' sequence
axis split over the model axis, read from
:func:`~..parallel.collectives.sequence_axis`): each rank holds ``T / M``
consecutive positions.  The decoder offsets its position embedding by
``rank * T / M``, each attention gathers the keys and values of every
position over the axis (:func:`~..parallel.collectives.all_gather`) and
masks causally against global positions, and :func:`next_token_loss`
scores the rank's positions against the next tokens, across the shard
boundary, as its share of the mean over all ``N (T - 1)`` predictions.

Tensor parallelism (:mod:`~..parallel.sharded` under Megatron
``param_specs``, read from :func:`~..parallel.collectives.tensor_role`):
the ``M`` ranks run one replicated program and split each block's work.
Rank ``m`` computes heads ``[m H / M, (m + 1) H / M)``: columns ``[m d /
M, (m + 1) d / M)`` of each of Q, K and V of the fused ``qkv`` weight and
bias, attention on those heads, and rows ``[m d / M, (m + 1) d / M)`` of
``proj.w``; and columns ``[m d_ff / M, (m + 1) d_ff / M)`` of ``ff1`` (w and
b) with the matching rows of ``ff2.w``.  Each sub-layer's partial ``[N, T,
d]`` is summed over the axis by
:func:`~..parallel.collectives.reduce_from_axis` before its output bias is
added; the layernormed input enters through
:func:`~..parallel.collectives.copy_to_axis`, so its cotangent is summed
over the axis and every rank gets the whole cotangent of what comes before
the split.  Every split leaf is read through
:func:`~..parallel.collectives.leaf_block`: the sharded step passes it as
this rank's block already (the block the plan recorded from a forward on
whole leaves), so no rank holds a whole split weight and each weight's
derivative is this rank's block of the whole program's; a forward given
whole leaves narrows them.  A head count or ``d_ff`` that ``M`` does not
divide keeps that sub-layer whole on every rank.  Of the leaves outside
the blocks, those that the plan splits over the axis (the Megatron specs'
``embed`` and ``pos`` under ``P(None, model)`` and the head's ``w`` under
``P(None, model)``, ``b`` under ``P(model)``) are computed on the rank's
block too: the embeddings look up the rank's ``d / M`` feature columns
of ``embed`` and ``pos`` and gather the ``[N, T, d]`` stream over the
axis (:func:`~..parallel.collectives.gather_from_axis`, whose backward
keeps the rank's block of the replicated cotangent); the decoders' tied
head contracts the rank's ``d / M`` columns of the stream with those of
``embed`` and sums the partial logits with one ``reduce_from_axis``; a
classifier head (the encoder's, or a decoder's untied one) computes the
rank's ``C / M`` classes and gathers them.  The logits are whole on every
rank.  A width that ``M`` does not divide keeps that leaf whole.

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

from ..parallel import collectives
from ..utils.flatten import tree_flatten, tree_unflatten
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


def _chunked_attention(q, k, v, causal: bool, chunk: int, offset: int = 0):
    """Query-chunked attention: row blocks of the score matrix, each block
    rematerialized, so the [T, T] probabilities are never alive at once in
    the forward, backward or curvature passes.  The same numbers as full
    attention (softmax rows are independent).  ``offset`` is the global
    position of q's first row."""
    T = q.shape[2]
    n_chunks, rem = divmod(T, chunk)
    if rem:
        raise ValueError(
            f"attn_chunk={chunk} must divide the sequence length {T}"
        )
    outs = [
        checkpoint(partial(_attend, causal=causal,
                           q_offset=offset + i * chunk))(
            q[:, :, i * chunk:(i + 1) * chunk], k, v
        )
        for i in range(n_chunks)
    ]
    return torch.cat(outs, dim=2)


def _columns(x, tp):
    """This rank's block of the last axis of the replicated activation
    ``x``, which enters through
    :func:`~..parallel.collectives.copy_to_axis` (its cotangent summed
    over the axis)."""
    k = x.shape[-1] // tp.size
    return collectives.copy_to_axis(x, tp).narrow(-1, tp.rank * k, k)


def _leaf_columns(w, tp, role):
    """This rank's block of the last axis of the parameter leaf ``w``
    (:func:`~..parallel.collectives.leaf_block`)."""
    return collectives.leaf_block(w, tp, role, w.dim() - 1)


def _inputs(params, tokens, onehot: bool):
    """The token plus position embeddings, [N, T, d].  A leaf split over
    the tensor axis is looked up on this rank's ``d / M`` columns, and the
    split part of the sum is gathered over the axis (module docstring)."""
    d = params["embed"].shape[-1]
    tp_e = collectives.tensor_role("embed", d)
    tp_p = collectives.tensor_role("pos", params["pos"].shape[-1])
    if tp_e is not None:
        params = dict(params, embed=_leaf_columns(params["embed"], tp_e,
                                                  "embed"))
    if tp_p is not None:
        params = dict(params, pos=_leaf_columns(params["pos"], tp_p, "pos"))
    e, p = _embed(params, tokens, onehot), _positions(params, tokens)
    if tp_e is not None and tp_p is not None:
        return collectives.gather_from_axis(e + p, tp_e)
    return (collectives.gather_from_axis(e, tp_e)
            + collectives.gather_from_axis(p, tp_p))


def _tied_head(x, embed):
    """``x @ embed.T``, or under a tensor axis that splits ``embed`` the
    rank's ``d / M`` columns of both contracted and the partial logits
    summed over the axis (module docstring)."""
    tp = collectives.tensor_role("embed", embed.shape[-1])
    if tp is None:
        return x @ embed.T
    partial_logits = _columns(x, tp) @ _leaf_columns(embed, tp, "embed").T
    return collectives.reduce_from_axis(partial_logits, tp)


def _head(p, x):
    """The dense head ``x @ w + b``, or under a tensor axis that splits it
    the rank's ``C / M`` classes, gathered over the axis (module
    docstring)."""
    tp = collectives.tensor_role("head", p["w"].shape[-1])
    if tp is None:
        return _apply_dense(p, x)
    x = collectives.copy_to_axis(x, tp)
    return collectives.gather_from_axis(
        x @ _leaf_columns(p["w"], tp, "head")
        + collectives.leaf_block(p["b"], tp, "head", 0), tp)


def _attention_sublayer(blk, x, n_heads: int, causal: bool, attn_chunk):
    """Pre-LN multi-head attention with residual: [N, T, d] -> [N, T, d].
    Shared by the dense block and the MoE block (:mod:`.moe`).  Under a
    tensor axis this rank computes its heads only (module docstring)."""
    N, T, d_model = x.shape
    d_head = d_model // n_heads

    h = _layernorm(blk["ln1"], x)
    tp = collectives.tensor_role("attention", n_heads)
    if tp is None:
        local_heads = n_heads
        qkv = _apply_dense(blk["qkv"], h)  # [N, T, 3*d]
    else:
        # the fused [d, 3d] weight holds Q, K and V at multiples of d, so
        # this rank's heads are one column range of each
        local_heads = n_heads // tp.size
        h = collectives.copy_to_axis(h, tp)
        w = collectives.leaf_block(blk["qkv"]["w"], tp, "attention", 1, 3)
        b = collectives.leaf_block(blk["qkv"]["b"], tp, "attention", 0, 3)
        qkv = h @ w + b
    q, k, v = torch.split(qkv, local_heads * d_head, dim=-1)

    def heads(t):  # [N, T, h * d_head] -> [N, h, T, d_head]
        return t.reshape(N, T, local_heads, d_head).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    seq = collectives.sequence_axis()
    offset = 0
    if seq is not None:  # context parallel: every position's keys
        k = collectives.all_gather(k, seq, dim=2)
        v = collectives.all_gather(v, seq, dim=2)
        offset = seq.rank * T
    if attn_chunk is not None and attn_chunk < T:
        out = _chunked_attention(q, k, v, causal, attn_chunk, offset)
    else:
        out = _attend(q, k, v, causal, offset)
    out = out.permute(0, 2, 1, 3).reshape(N, T, local_heads * d_head)
    if tp is None:
        return x + _apply_dense(blk["proj"], out)
    rows = collectives.leaf_block(blk["proj"]["w"], tp, "attention", 0)
    return x + (collectives.reduce_from_axis(out @ rows, tp)
                + blk["proj"]["b"])


def _mlp_sublayer(blk, x):
    """Pre-LN GELU feed-forward with residual: [N, T, d] -> [N, T, d].
    Under a tensor axis this rank computes its ``d_ff / M`` columns of
    ``ff1`` and the matching rows of ``ff2`` (module docstring)."""
    h = _layernorm(blk["ln2"], x)
    tp = collectives.tensor_role("mlp", blk["ff1"]["w"].shape[-1])
    if tp is None:
        h = F.gelu(_apply_dense(blk["ff1"], h), approximate="tanh")
        return x + _apply_dense(blk["ff2"], h)
    h = collectives.copy_to_axis(h, tp)
    w1 = collectives.leaf_block(blk["ff1"]["w"], tp, "mlp", 1)
    b1 = collectives.leaf_block(blk["ff1"]["b"], tp, "mlp", 0)
    w2 = collectives.leaf_block(blk["ff2"]["w"], tp, "mlp", 0)
    h = F.gelu(h @ w1 + b1, approximate="tanh")
    return x + (collectives.reduce_from_axis(h @ w2, tp) + blk["ff2"]["b"])


def _block(blk, x, n_heads: int, causal: bool = False, attn_chunk=None):
    """One pre-LN attention + MLP residual block: [N, T, d] -> [N, T, d]."""
    x = _attention_sublayer(blk, x, n_heads, causal, attn_chunk)
    return _mlp_sublayer(blk, x)


def stack_blocks(blocks):
    """List of per-layer block trees -> one tree with a leading layer axis
    (the layout of :func:`~..parallel.pipeline.pipeline_blocks`)."""
    flat = [tree_flatten(blk) for blk in blocks]
    treedef = flat[0][1]
    if any(d != treedef for _, d in flat[1:]):
        raise ValueError("stack_blocks: the blocks' trees differ")
    return tree_unflatten(
        treedef, [torch.stack(leaves) for leaves in zip(*(f for f, _ in flat))])


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
    if collectives.sequence_axis() is not None:
        raise ValueError(
            "transformer_apply pools over the sequence; context parallelism "
            "(a split sequence axis) is for the decoders."
        )
    x = _inputs(params, tokens, embed_onehot)
    x = _run_blocks(
        params["blocks"], x, n_heads, scan_layers, remat,
        attn_chunk=attn_chunk,
    )
    pooled = torch.mean(x, dim=1)
    return _head(params["head"], pooled)


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
    applied per block against global positions.  Under context
    parallelism ``tokens`` are this rank's positions (module docstring)."""
    x = _inputs(params, tokens, embed_onehot)
    x = _run_blocks(
        params["blocks"], x, n_heads, scan_layers, remat, causal=True,
        attn_chunk=attn_chunk,
    )
    x = _layernorm(params["ln_f"], x)
    if "head" in params:
        return _head(params["head"], x)
    return _tied_head(x, params["embed"])


def _positions(params, tokens):
    """The position embeddings of ``tokens``' positions: ``[0, T)``, or
    under context parallelism this rank's ``[rank T, (rank + 1) T)``."""
    T = tokens.shape[1]
    seq = collectives.sequence_axis()
    start = 0 if seq is None else seq.rank * T
    return params["pos"][start:start + T]


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
    1)``.  Thread it through the batch so every phase of a step sees it.

    Under context parallelism ``logits``, ``tokens`` and ``mask`` hold this
    rank's positions: the rank scores them against the next tokens of the
    whole sequence (gathered, no derivative) and returns its share, the
    sum of its terms over the whole count; the shares sum to the mean."""
    seq = collectives.sequence_axis()
    if seq is not None and seq.size > 1:
        return _next_token_share(logits, tokens, onehot, mask, seq)
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


def _next_token_share(logits, tokens, onehot, mask, seq):
    """:func:`next_token_loss`'s share on this rank's positions: position
    ``t`` (global ``rank T + t``) predicts token ``rank T + t + 1`` of the
    gathered sequence; the last global position predicts nothing."""
    T = tokens.shape[1]
    start = seq.rank * T
    whole = collectives._gather(tokens.contiguous(), seq, 1)
    # predictions with a next token: all but the global last position
    stop = min(T, whole.shape[1] - 1 - start)
    tgt = whole[:, start + 1:start + 1 + stop]
    logp = torch.log_softmax(logits[:, :stop, :], dim=-1)
    if onehot:
        ll = torch.sum(logp * _one_hot(tgt, logits.shape[-1], logp.dtype),
                       dim=-1)
    else:
        ll = torch.gather(logp, -1, tgt[..., None].long())[..., 0]
    if mask is None:
        return -torch.sum(ll) / (tokens.shape[0] * (whole.shape[1] - 1))
    m_whole = collectives._gather(mask.contiguous(), seq, 1)[:, 1:]
    m = m_whole[:, start:start + stop].to(ll.dtype)
    return -torch.sum(ll * m) / torch.clamp(
        torch.sum(m_whole.to(ll.dtype)), min=1.0)
