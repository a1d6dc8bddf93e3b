"""Mixture-of-Experts causal decoder LM with GShard-style einsum dispatch
(port of :mod:`pytorchhessianfree_tpu.models.moe`).

Routing is expressed as einsums against 0/1 dispatch and gate-valued
combine tensors ``[S, Gg, E, C]`` (S router groups of Gg tokens, E experts,
C slots per expert), not as gathers.  The top-k masks and slot positions
are piecewise constant in the router probabilities (zero tangent), so
gradients and GGN tangents flow only through the gate values and the
expert MLPs, and CG's fixed quadratic model holds as for a dense model.

Top-2 (GShard) or top-1 (Switch, ``top_k=1``) routing with per-expert,
per-group capacity: first choices claim slots before second choices, a
choice over capacity is dropped (the residual stream carries the token),
top-2 gates are renormalized, a top-1 gate is the raw router probability.
The Switch load-balance loss comes back with ``return_aux=True``.  The
JAX package's ``vmap`` over router groups is a leading group axis here.

Expert parallelism (:func:`moe_param_specs` through
:mod:`~..parallel.sharded`, read from
:func:`~..parallel.collectives.expert_axis`): the router and the dispatch
stay replicated; each of the axis's ``M`` ranks runs the expert MLPs of
its ``E / M`` experts on their slots only, and one ``all_reduce`` per
layer sums the ranks' partial combines.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..parallel import collectives
from ..parallel.mesh import ExpertSpec, PartitionSpec as P
from ..utils.remat import checkpoint
from .transformer import (
    _attention_sublayer,
    _dense,
    _embed,
    _layernorm,
    _ln_init,
    _normal,
    _one_hot,
)


def init_moe_decoder_lm(
    generator: torch.Generator,
    vocab: int = 64,
    d_model: int = 32,
    n_heads: int = 4,
    n_layers: int = 2,
    d_ff: int = 64,
    n_experts: int = 4,
    max_len: int = 16,
    dtype: torch.dtype = torch.float32,
) -> Any:
    """Causal decoder LM whose per-block FFN is a top-2 MoE layer.

    Block params: attention as in :mod:`.transformer` plus ``gate``
    [d_model, E] and batched expert MLPs ``w1`` [E, d_model, d_ff], ``b1``
    [E, d_ff], ``w2`` [E, d_ff, d_model], ``b2`` [E, d_model].  The head is
    tied to the embedding.  Drawn on the generator's device, which is also
    where the tensors stay."""
    del n_heads  # the head count is an argument of the apply function
    device = generator.device

    def normal(shape, fan_in):
        return _normal(generator, shape, dtype, device) / math.sqrt(fan_in)

    params = {
        "embed": _normal(generator, (vocab, d_model), dtype, device) * 0.1,
        "pos": _normal(generator, (max_len, d_model), dtype, device) * 0.02,
        "blocks": [],
        "ln_f": _ln_init(d_model, dtype, device),
    }
    for _ in range(n_layers):
        params["blocks"].append(
            {
                "ln1": _ln_init(d_model, dtype, device),
                "qkv": _dense(generator, d_model, 3 * d_model, dtype, device),
                "proj": _dense(generator, d_model, d_model, dtype, device),
                "ln2": _ln_init(d_model, dtype, device),
                "gate": normal((d_model, n_experts), d_model),
                "w1": normal((n_experts, d_model, d_ff), d_model),
                "b1": torch.zeros((n_experts, d_ff), dtype=dtype,
                                  device=device),
                "w2": normal((n_experts, d_ff, d_model), d_ff),
                "b2": torch.zeros((n_experts, d_model), dtype=dtype,
                                  device=device),
            }
        )
    return params


def _topk_dispatch(probs, capacity: int, top_k: int = 2):
    """GShard/Switch dispatch and combine tensors from router
    probabilities.

    ``probs``: [..., G, E] softmax outputs (any leading group axes) ->
    ``(dispatch [..., G, E, C] 0/1, combine [..., G, E, C], aux [...])``.
    Slot positions are cumulative counts over the token axis (arrival
    order), first choices before second choices.  ``aux`` is the Switch
    load-balance loss ``E * sum_e f_e * P_e`` (f_e the first-choice
    fraction, P_e the mean router probability)."""
    E = probs.shape[-1]
    dtype = probs.dtype
    idx1 = torch.argmax(probs, dim=-1)
    mask1 = _one_hot(idx1, E, dtype)

    pos1 = torch.cumsum(mask1, dim=-2) - mask1
    keep1 = mask1 * (pos1 < capacity).to(dtype)
    p1 = torch.sum(pos1 * keep1, dim=-1).to(torch.int64)
    oh1 = _one_hot(p1, capacity, dtype)  # [..., G, C]
    g1 = torch.sum(probs * mask1, dim=-1)

    f = torch.mean(mask1, dim=-2)
    P = torch.mean(probs, dim=-2)
    aux = E * torch.sum(f * P, dim=-1)

    if top_k == 1:
        dispatch = keep1[..., None] * oh1[..., None, :]
        combine = (keep1 * g1[..., None])[..., None] * oh1[..., None, :]
        return dispatch, combine, aux

    probs_wo1 = probs * (1.0 - mask1)
    idx2 = torch.argmax(probs_wo1, dim=-1)
    mask2 = _one_hot(idx2, E, dtype)
    count1 = torch.sum(mask1, dim=-2, keepdim=True)
    pos2 = torch.cumsum(mask2, dim=-2) - mask2 + count1
    keep2 = mask2 * (pos2 < capacity).to(dtype)
    p2 = torch.sum(pos2 * keep2, dim=-1).to(torch.int64)
    oh2 = _one_hot(p2, capacity, dtype)
    g2 = torch.sum(probs * mask2, dim=-1)

    denom = g1 + g2
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    g1n, g2n = g1 / denom, g2 / denom

    dispatch = (
        keep1[..., None] * oh1[..., None, :]
        + keep2[..., None] * oh2[..., None, :]
    )
    combine = (
        (keep1 * g1n[..., None])[..., None] * oh1[..., None, :]
        + (keep2 * g2n[..., None])[..., None] * oh2[..., None, :]
    )
    return dispatch, combine, aux


def _moe_ffn(blk, h, capacity_factor: float, router_groups: int = 1,
             top_k: int = 2):
    """Top-k MoE feed-forward over [N, T, d] activations -> (out, aux)."""
    N, T, d = h.shape
    E = blk["gate"].shape[-1]
    if top_k not in (1, 2):
        raise ValueError(f"top_k must be 1 or 2, got {top_k}")
    if E < 2:
        raise ValueError(
            f"routing needs >= 2 experts, got {E} (with one expert the "
            "second argmax would silently re-select it; use a dense FFN)"
        )
    G = N * T
    if G % router_groups != 0:
        raise ValueError(
            f"router_groups={router_groups} must divide the token count "
            f"{G} (= batch {N} x seq {T})"
        )
    Gg = G // router_groups
    capacity = int(math.ceil(capacity_factor * top_k * Gg / E))
    # [S groups, Gg, d]: tokens compete for expert slots within their group
    hg = h.reshape(router_groups, Gg, d)

    logits = torch.einsum("sgd,de->sge", hg, blk["gate"])
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, aux = _topk_dispatch(probs, capacity, top_k)
    aux = torch.mean(aux)

    w1, b1, w2, b2 = blk["w1"], blk["b1"], blk["w2"], blk["b2"]
    ep = collectives.expert_axis()
    if ep is not None and ep.size > 1:  # this rank's experts only
        if E % ep.size:
            raise ValueError(
                f"{E} experts do not divide over {ep.size} ranks")
        lo, hi = ep.rank * E // ep.size, (ep.rank + 1) * E // ep.size
        dispatch, combine = dispatch[..., lo:hi, :], combine[..., lo:hi, :]
        w1, b1, w2, b2 = w1[lo:hi], b1[lo:hi], w2[lo:hi], b2[lo:hi]

    xe = torch.einsum("sgec,sgd->secd", dispatch, hg)
    h1 = F.gelu(
        torch.einsum("secd,edf->secf", xe, w1) + b1[None, :, None, :],
        approximate="tanh",
    )
    ye = torch.einsum("secf,efd->secd", h1, w2) + b2[None, :, None, :]
    out = torch.einsum("sgec,secd->sgd", combine, ye)
    if ep is not None:
        out = collectives.all_reduce_sum(out, ep)
    return out.reshape(N, T, d), aux


def _moe_block(
    blk, x, n_heads: int, capacity_factor: float, attn_chunk=None,
    router_groups: int = 1,
    top_k: int = 2,
):
    """Causal pre-LN attention + MoE-FFN residual block -> (x, aux)."""
    x = _attention_sublayer(blk, x, n_heads, True, attn_chunk)
    h = _layernorm(blk["ln2"], x)
    moe_out, aux = _moe_ffn(blk, h, capacity_factor, router_groups, top_k)
    return x + moe_out, aux


def moe_decoder_lm_apply(
    params,
    tokens: torch.Tensor,
    n_heads: int = 4,
    capacity_factor: float = 1.25,
    router_groups: int = 1,
    top_k: int = 2,
    scan_layers: bool = True,
    remat: bool = False,
    attn_chunk: Optional[int] = None,
    embed_onehot: bool = False,
    return_aux: bool = False,
):
    """Causal forward pass.  ``tokens``: [N, T] integers -> [N, T, vocab]
    logits (tied head); ``return_aux=True`` also returns the mean Switch
    load-balance loss over the layers.  ``router_groups=S`` routes with
    per-group capacity over S equal slices of the flattened tokens;
    ``top_k=1`` is Switch routing.  ``scan_layers``, ``remat``,
    ``attn_chunk`` and ``embed_onehot`` are as on
    :func:`~.transformer.decoder_lm_apply`."""
    del scan_layers  # layout knob of the JAX package
    if collectives.sequence_axis() is not None:
        raise ValueError(
            "The MoE LM routes over all of a group's tokens; context "
            "parallelism (a split sequence axis) is not supported for it."
        )
    T = tokens.shape[1]
    x = _embed(params, tokens, embed_onehot) + params["pos"][:T]
    block = partial(
        _moe_block, n_heads=n_heads, capacity_factor=capacity_factor,
        attn_chunk=attn_chunk, router_groups=router_groups, top_k=top_k,
    )
    if remat:
        block = checkpoint(block)
    auxs = []
    for blk in params["blocks"]:
        x, aux = block(blk, x)
        auxs.append(aux)
    x = _layernorm(params["ln_f"], x)
    logits = x @ params["embed"].T
    if return_aux:
        return logits, torch.mean(torch.stack(auxs))
    return logits


def moe_param_specs(n_layers: int):
    """Expert-parallel ``param_specs`` for
    :func:`~..parallel.sharded.make_sharded_hf_step`: the expert axis of
    every expert tensor splits over the ``model`` mesh axis; attention,
    layernorms, the router gate and the embeddings stay replicated.  Under
    these specs (:class:`~..parallel.mesh.ExpertSpec` marks the experts)
    each rank keeps its experts' weights between steps and runs the MoE
    feed-forward on its own experts (module docstring)."""
    ep = {
        "ln1": P(), "ln2": P(), "qkv": P(), "proj": P(), "gate": P(),
        "w1": ExpertSpec("model", None, None),
        "b1": ExpertSpec("model", None),
        "w2": ExpertSpec("model", None, None),
        "b2": ExpertSpec("model", None),
    }
    return {
        "embed": P(),
        "pos": P(),
        "ln_f": P(),
        "blocks": [dict(ep) for _ in range(n_layers)],
    }
