"""Transformer parity: the port's encoder classifier and causal decoder LM
against the JAX models on the same weights (carried over with
``params_from_jax``), in f64 at narrow width: forwards, both embedding
forms, chunked attention, causality, ``next_token_loss``, parameter counts,
the GGN matvec and one Hessian-free step.

Tolerances: forwards and losses rtol 1e-10 (the two frameworks sum in other
orders, f64); flat vectors norm-wise 1e-10 (gradient) and 1e-9 (matvec).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.models import transformer as jt  # noqa: E402
from pytorchhessianfree_tpu.optimizer import (  # noqa: E402
    _build_matvec_and_grad as j_build,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import transformer as tt  # noqa: E402
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad as t_build,
)
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402

from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

VOCAB, D, HEADS, LAYERS, D_FF, T = 16, 16, 4, 2, 32, 8


def _carry(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def _decoder(seed, tied_head=True, max_len=T):
    jparams = jt.init_decoder_lm(
        jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D, n_heads=HEADS,
        n_layers=LAYERS, d_ff=D_FF, max_len=max_len, dtype=jnp.float64,
        tied_head=tied_head,
    )
    return jparams, _carry(jparams)


def _encoder(seed):
    jparams = jt.init_transformer(
        jax.random.PRNGKey(seed), vocab=VOCAB, d_model=D, n_heads=HEADS,
        n_layers=LAYERS, d_ff=D_FF, num_classes=5, max_len=T,
        dtype=jnp.float64,
    )
    return jparams, _carry(jparams)


def _tokens(seed, n=3, t=T):
    return np.random.default_rng(seed).integers(0, VOCAB, (n, t))


def _affine_tokens(seed, n=4, t=T):
    """The affine next-token rule of benchmarks/decoder_lm_bench.py."""
    start = np.random.default_rng(seed).integers(0, VOCAB, n)
    toks = [start]
    for _ in range(t - 1):
        toks.append((5 * toks[-1] + 3) % VOCAB)
    return np.stack(toks, axis=1)


def test_trees_and_flat_vectors_match_jax():
    for jparams, tparams in (_decoder(0), _decoder(0, tied_head=False),
                             _encoder(0)):
        j_leaves = jax.tree_util.tree_leaves(jparams)
        t_leaves, _ = tree_flatten(tparams)
        assert [a.shape for a in j_leaves] == [tuple(t.shape)
                                               for t in t_leaves]
        np.testing.assert_array_equal(
            thf.TrainableRavel(tparams).ravel(tparams).numpy(),
            np.asarray(jhf.TrainableRavel(jparams).ravel(jparams)),
        )


@pytest.mark.parametrize(
    "kwargs",
    [dict(), dict(embed_onehot=True), dict(attn_chunk=2),
     dict(remat=True, scan_layers=False)],
)
def test_encoder_forward_matches_jax(kwargs):
    jparams, tparams = _encoder(1)
    toks = _tokens(1)
    j_out = jt.transformer_apply(jparams, jnp.asarray(toks), n_heads=HEADS,
                                 **kwargs)
    t_out = tt.transformer_apply(tparams, torch.tensor(toks), n_heads=HEADS,
                                 **kwargs)
    assert t_out.shape == (3, 5)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-10)


@pytest.mark.parametrize(
    "tied_head,kwargs",
    [(True, dict()), (False, dict()), (True, dict(embed_onehot=True)),
     (True, dict(attn_chunk=4, remat=True))],
)
def test_decoder_forward_matches_jax(tied_head, kwargs):
    jparams, tparams = _decoder(2, tied_head=tied_head)
    toks = _tokens(2)
    j_out = jt.decoder_lm_apply(jparams, jnp.asarray(toks), n_heads=HEADS,
                                **kwargs)
    t_out = tt.decoder_lm_apply(tparams, torch.tensor(toks), n_heads=HEADS,
                                **kwargs)
    assert t_out.shape == (3, T, VOCAB)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-10)


def test_embed_forms_match_jax_and_each_other():
    jparams, tparams = _decoder(3)
    toks = _tokens(3)
    gather = tt._embed(tparams, torch.tensor(toks), onehot=False)
    onehot = tt._embed(tparams, torch.tensor(toks), onehot=True)
    # one-hot rows select exact values: equal bit for bit
    assert torch.equal(gather, onehot)
    for form in (False, True):
        np.testing.assert_array_equal(
            tt._embed(tparams, torch.tensor(toks), form).numpy(),
            np.asarray(jt._embed(jparams, jnp.asarray(toks), form)),
        )


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_attention_matches_full_and_jax(causal, chunk):
    rng = np.random.default_rng(chunk)
    q, k, v = (rng.standard_normal((2, 3, T, 5)) for _ in range(3))
    full = tt._attend(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                      causal)
    chunked = tt._chunked_attention(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), causal, chunk)
    j_chunked = jt._chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, chunk)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(j_chunked),
                               rtol=1e-10, atol=1e-14)


def test_attn_chunk_must_divide_the_sequence():
    _, tparams = _decoder(4)
    with pytest.raises(ValueError, match="must divide"):
        tt.decoder_lm_apply(tparams, torch.tensor(_tokens(4)),
                            n_heads=HEADS, attn_chunk=3)


@pytest.mark.parametrize("attn_chunk", [None, 2])
def test_decoder_is_causal(attn_chunk):
    _, tparams = _decoder(5)
    toks = _tokens(5, n=1)
    other = toks.copy()
    t = 5
    other[0, t] = (other[0, t] + 1) % VOCAB
    a = tt.decoder_lm_apply(tparams, torch.tensor(toks), n_heads=HEADS,
                            attn_chunk=attn_chunk)
    b = tt.decoder_lm_apply(tparams, torch.tensor(other), n_heads=HEADS,
                            attn_chunk=attn_chunk)
    # positions before t never see token t; t and after do
    assert torch.equal(a[:, :t], b[:, :t])
    assert not torch.allclose(a[:, t:], b[:, t:])


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("use_mask", [False, True])
def test_next_token_loss_matches_jax(onehot, use_mask):
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, T, VOCAB))
    toks = _tokens(6)
    mask = (rng.random((3, T)) < 0.6).astype(np.float64) if use_mask else None
    j = jt.next_token_loss(jnp.asarray(logits), jnp.asarray(toks),
                           onehot=onehot,
                           mask=None if mask is None else jnp.asarray(mask))
    t = tt.next_token_loss(torch.tensor(logits), torch.tensor(toks),
                           onehot=onehot,
                           mask=None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-12)


def test_next_token_loss_with_an_empty_mask_is_zero():
    logits = torch.zeros((2, T, VOCAB), dtype=torch.float64)
    toks = torch.tensor(_tokens(7, n=2))
    mask = torch.zeros((2, T), dtype=torch.float64)
    assert float(tt.next_token_loss(logits, toks, mask=mask)) == 0.0


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(vocab=VOCAB, d_model=D, n_layers=LAYERS, d_ff=D_FF, max_len=T),
        dict(vocab=VOCAB, d_model=D, n_layers=LAYERS, d_ff=D_FF, max_len=T,
             tied_head=False),
        # the full width of benchmarks/decoder_lm_bench.py
        dict(vocab=1024, d_model=512, n_heads=8, n_layers=6, d_ff=2048,
             max_len=128),
    ],
)
def test_parameter_counts_match_jax(kwargs):
    shapes = jax.eval_shape(
        lambda k: jt.init_decoder_lm(k, **kwargs), jax.random.PRNGKey(0)
    )
    j_count = sum(int(np.prod(a.shape))
                  for a in jax.tree_util.tree_leaves(shapes))
    tparams = tt.init_decoder_lm(torch.Generator().manual_seed(0), **kwargs)
    t_count = sum(t.numel() for t in tree_flatten(tparams)[0])
    assert t_count == j_count
    if kwargs["d_model"] == 512:
        assert t_count == 19_505_152
        assert thf.TrainableRavel(tparams, pad_to_multiple=1024).dim == (
            19_505_152
        )


def _lm_fns(j_or_t, **kwargs):
    mod = jt if j_or_t == "j" else tt
    pkg = jhf if j_or_t == "j" else thf
    return pkg.HFModelFns(
        model_fn=lambda p, x: mod.decoder_lm_apply(p, x, n_heads=HEADS,
                                                   **kwargs),
        loss_outer=mod.next_token_loss,
    )


@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
def test_loss_gradient_and_matvecs_match_jax(curvature_opt):
    jparams, tparams = _decoder(8)
    toks = _affine_tokens(8)
    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    rng = np.random.default_rng(8)
    vs = rng.standard_normal((2, tr.dim))

    @jax.jit
    def j_run(params, batch, vs):
        loss, grad, mvp = j_build(
            _lm_fns("j"), jhf.HFConfig(curvature_opt=curvature_opt), jr,
            params, batch,
        )
        return loss, grad, jax.lax.map(mvp, vs)

    j_loss, j_grad, j_mvps = j_run(
        jparams, (jnp.asarray(toks), jnp.asarray(toks)), jnp.asarray(vs)
    )
    t_loss, t_grad, t_mvp = t_build(
        _lm_fns("t"), thf.HFConfig(curvature_opt=curvature_opt), tr,
        tparams, (torch.tensor(toks), torch.tensor(toks)),
    )
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-10)
    assert_vec_close(t_grad.numpy(), np.asarray(j_grad), 1e-10)
    for v, j_mv in zip(vs, np.asarray(j_mvps)):
        assert_vec_close(t_mvp(torch.tensor(v)).numpy(), j_mv, 1e-9)


def test_one_hf_step_matches_jax():
    jparams, tparams = _decoder(9)
    toks = _affine_tokens(9)
    kw = dict(damping=1.0, cg_max_iter=10)
    j_opt = jhf.HessianFree(jparams, model_fn=_lm_fns("j").model_fn,
                            loss_outer=jt.next_token_loss, **kw)
    t_opt = thf.HessianFree(tparams, model_fn=_lm_fns("t").model_fn,
                            loss_outer=tt.next_token_loss, **kw)
    j_opt.step((jnp.asarray(toks), jnp.asarray(toks)))
    t_opt.step((torch.tensor(toks), torch.tensor(toks)))
    assert_same_step(t_opt, j_opt, 1e-8)
    assert t_opt.history["final_losses"][0] < t_opt.history["init_losses"][0]


def test_encoder_hf_step_matches_jax():
    jparams, tparams = _encoder(10)
    toks = _tokens(10, n=6)
    labels = np.random.default_rng(10).integers(0, 5, 6)
    kw = dict(damping=1.0, cg_max_iter=10)
    j_opt = jhf.HessianFree(
        jparams, model_fn=lambda p, x: jt.transformer_apply(p, x, HEADS),
        loss_outer=jhf.models.cross_entropy_loss, **kw)
    t_opt = thf.HessianFree(
        tparams, model_fn=lambda p, x: tt.transformer_apply(p, x, HEADS),
        loss_outer=thf.models.cross_entropy_loss, **kw)
    j_opt.step((jnp.asarray(toks), jnp.asarray(labels)))
    t_opt.step((torch.tensor(toks), torch.tensor(labels)))
    assert_same_step(t_opt, j_opt, 1e-8)
