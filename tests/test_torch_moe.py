"""MoE parity: the port's GShard/Switch dispatch, MoE FFN, MoE decoder LM,
its GGN and Hessian matvecs and one Hessian-free step against the JAX
package on the same weights, in f64 at narrow width (the counterparts of
tests/test_moe.py).

Draws are f64 normals, so no two router probabilities of a token tie and
both packages' first-maximum ``argmax`` pick the same experts.  Tolerances:
dispatch tensors exactly equal (0/1 masks, gates from the same f64 softmax
up to rounding: rtol 1e-12); forwards rtol 1e-10; flat vectors norm-wise
1e-10 (gradient) and 1e-9 (matvecs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.models import moe as jm  # noqa: E402
from pytorchhessianfree_tpu.models import transformer as jt  # noqa: E402
from pytorchhessianfree_tpu.optimizer import (  # noqa: E402
    _build_matvec_and_grad as j_build,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import moe as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.models import transformer as tt  # noqa: E402
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad as t_build,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402

from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

VOCAB, D, HEADS, LAYERS, D_FF, E, T = 16, 16, 4, 2, 32, 4, 8


def _carry(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def _lm(seed, n_layers=LAYERS, n_experts=E):
    jparams = jm.init_moe_decoder_lm(
        jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D, n_heads=HEADS,
        n_layers=n_layers, d_ff=D_FF, n_experts=n_experts, max_len=T,
        dtype=jnp.float64,
    )
    return jparams, _carry(jparams)


def _block(seed):
    jparams, tparams = _lm(seed, n_layers=1)
    return jparams["blocks"][0], tparams["blocks"][0]


def _affine_tokens(seed, n=4):
    start = np.random.default_rng(seed).integers(0, VOCAB, n)
    toks = [start]
    for _ in range(T - 1):
        toks.append((5 * toks[-1] + 3) % VOCAB)
    return np.stack(toks, axis=1)


def _probs(seed, g, e, bias=None):
    logits = np.random.default_rng(seed).standard_normal((g, e))
    if bias is not None:
        logits = logits + bias
    z = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return z / z.sum(axis=-1, keepdims=True)


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize(
    "capacity,bias",
    [(6, None), (2, None), (3, np.array([4.0, 0.0, 0.0, 0.0]))],
    ids=["roomy", "tight", "crowded-expert"],
)
def test_topk_dispatch_matches_jax(top_k, capacity, bias):
    probs = _probs(capacity, 12, E, bias)
    j = jm._topk_dispatch(jnp.asarray(probs), capacity, top_k)
    t = tm._topk_dispatch(torch.tensor(probs), capacity, top_k)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(float(t[2]), float(j[2]), rtol=1e-12)
    if bias is not None:
        # expert 0 is every token's first choice: some first choices drop
        first = np.asarray(j[0])[:, 0, :].sum()
        assert first == capacity < 12


def test_topk_dispatch_takes_a_leading_group_axis():
    probs = np.stack([_probs(s, 8, E) for s in range(3)])
    t = tm._topk_dispatch(torch.tensor(probs), 3, 2)
    for s in range(3):
        j = jm._topk_dispatch(jnp.asarray(probs[s]), 3, 2)
        np.testing.assert_array_equal(t[0][s].numpy(), np.asarray(j[0]))
        np.testing.assert_allclose(t[1][s].numpy(), np.asarray(j[1]),
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(float(t[2][s]), float(j[2]), rtol=1e-12)


@pytest.mark.parametrize(
    "capacity_factor,router_groups,top_k",
    [(1.25, 1, 2), (0.4, 1, 2), (0.5, 2, 2), (0.6, 1, 1), (1.0, 4, 1)],
)
def test_moe_ffn_matches_jax(capacity_factor, router_groups, top_k):
    jblk, tblk = _block(11)
    h = np.random.default_rng(11).standard_normal((2, T, D))
    j_out, j_aux = jm._moe_ffn(jblk, jnp.asarray(h), capacity_factor,
                               router_groups, top_k)
    t_out, t_aux = tm._moe_ffn(tblk, torch.tensor(h), capacity_factor,
                               router_groups, top_k)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-10,
                               atol=1e-13)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-12)
    assert float(t_aux) > 0.0


def test_moe_ffn_rejects_bad_routing_arguments():
    jblk, tblk = _block(12)
    h = torch.tensor(np.random.default_rng(12).standard_normal((2, T, D)))
    with pytest.raises(ValueError, match="must divide the token count"):
        tm._moe_ffn(tblk, h, 0.5, router_groups=3)
    with pytest.raises(ValueError, match="top_k must be"):
        tm._moe_ffn(tblk, h, 1.0, top_k=3)
    _, single = _lm(12, n_layers=1, n_experts=1)
    with pytest.raises(ValueError, match=">= 2 experts"):
        tm.moe_decoder_lm_apply(single, torch.tensor(_affine_tokens(12)),
                                n_heads=HEADS)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(return_aux=True),
        dict(top_k=1, capacity_factor=0.6),
        dict(router_groups=2, capacity_factor=0.5),
        dict(remat=True, attn_chunk=2, scan_layers=False),
        dict(embed_onehot=True),
    ],
)
def test_forward_matches_jax(kwargs):
    jparams, tparams = _lm(13)
    toks = _affine_tokens(13)
    j = jm.moe_decoder_lm_apply(jparams, jnp.asarray(toks), n_heads=HEADS,
                                **kwargs)
    t = tm.moe_decoder_lm_apply(tparams, torch.tensor(toks), n_heads=HEADS,
                                **kwargs)
    if kwargs.get("return_aux"):
        (j, j_aux), (t, t_aux) = j, t
        np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-12)
    assert t.shape == (4, T, VOCAB)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10)


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(vocab=VOCAB, d_model=D, n_layers=LAYERS, d_ff=D_FF,
             n_experts=E, max_len=T),
        # the full width of benchmarks/moe_lm_bench.py
        dict(vocab=1024, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
             n_experts=8, max_len=128),
    ],
)
def test_parameter_counts_match_jax(kwargs):
    shapes = jax.eval_shape(
        lambda k: jm.init_moe_decoder_lm(k, **kwargs), jax.random.PRNGKey(0)
    )
    j_count = sum(int(np.prod(a.shape))
                  for a in jax.tree_util.tree_leaves(shapes))
    if kwargs["d_model"] == 512:
        assert j_count == 107_717_632
        # shapes only: the full-width draw is left to the card
        kwargs = dict(kwargs, n_layers=1)
        j_count -= 5 * sum(
            int(np.prod(a.shape))
            for a in jax.tree_util.tree_leaves(shapes["blocks"][0])
        )
    tparams = tm.init_moe_decoder_lm(torch.Generator().manual_seed(0),
                                     **kwargs)
    assert sum(t.numel() for t in tree_flatten(tparams)[0]) == j_count


def test_moe_param_specs_waits_for_the_parallel_layer():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.moe_param_specs(2)


def _fns(j_or_t, **kwargs):
    mod = jm if j_or_t == "j" else tm
    lm = jt if j_or_t == "j" else tt
    pkg = jhf if j_or_t == "j" else thf
    return pkg.HFModelFns(
        model_fn=lambda p, x: mod.moe_decoder_lm_apply(p, x, n_heads=HEADS,
                                                       **kwargs),
        loss_outer=lm.next_token_loss,
    )


@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
def test_loss_gradient_and_matvecs_match_jax(curvature_opt):
    jparams, tparams = _lm(14)
    toks = _affine_tokens(14)
    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    rng = np.random.default_rng(14)
    vs = rng.standard_normal((2, tr.dim))

    @jax.jit
    def j_run(params, batch, vs):
        loss, grad, mvp = j_build(
            _fns("j"), jhf.HFConfig(curvature_opt=curvature_opt), jr,
            params, batch,
        )
        return loss, grad, jax.lax.map(mvp, vs)

    j_loss, j_grad, j_mvps = j_run(
        jparams, (jnp.asarray(toks), jnp.asarray(toks)), jnp.asarray(vs)
    )
    t_loss, t_grad, t_mvp = t_build(
        _fns("t"), thf.HFConfig(curvature_opt=curvature_opt), tr, tparams,
        (torch.tensor(toks), torch.tensor(toks)),
    )
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-10)
    assert_vec_close(t_grad.numpy(), np.asarray(j_grad), 1e-10)
    for v, j_mv in zip(vs, np.asarray(j_mvps)):
        assert_vec_close(t_mvp(torch.tensor(v)).numpy(), j_mv, 1e-9)


@pytest.mark.parametrize("kwargs", [dict(), dict(return_aux=True)])
def test_one_hf_step_matches_jax(kwargs):
    jparams, tparams = _lm(15, n_layers=1)
    toks = _affine_tokens(15)
    cfg = dict(damping=1.0, cg_max_iter=10)

    def outer(lm):
        if kwargs:
            return lambda out, t: lm.next_token_loss(out[0], t) + 0.01 * out[1]
        return lm.next_token_loss

    j_opt = jhf.HessianFree(jparams, model_fn=_fns("j", **kwargs).model_fn,
                            loss_outer=outer(jt), **cfg)
    t_opt = thf.HessianFree(tparams, model_fn=_fns("t", **kwargs).model_fn,
                            loss_outer=outer(tt), **cfg)
    j_opt.step((jnp.asarray(toks), jnp.asarray(toks)))
    t_opt.step((torch.tensor(toks), torch.tensor(toks)))
    assert_same_step(t_opt, j_opt, 1e-8)
    assert t_opt.history["final_losses"][0] < t_opt.history["init_losses"][0]
