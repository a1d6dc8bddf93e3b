"""The port's bf16 curvature against the JAX package's
(``HFConfig(curvature_dtype=jnp.bfloat16)``), on the narrow decoder LM with
weights carried over from JAX:

- the bf16 forward equals JAX's bit for bit (d_head 6, where the order of
  rounding the scores and scaling them shows);
- the bf16 GGN and Hessian matvecs lie from JAX's within half their
  distance from the f32 matvec, that distance is JAX's own within a third,
  and it exceeds f32 rounding (a cast happened).

PyTorch's softmax and GELU compute in f32 inside and round once; JAX's are
composites that round after every op.  The tests swap JAX's for round-once
forms (the JAX package itself is unchanged) and compile with XLA's excess
precision off, so that every other op rounds where eager PyTorch does.
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
    _build_matvec_and_grad,
    _cast_floating,
)

VOCAB, T, HEADS = 16, 8, 4


def _lm_fns():
    return thf.HFModelFns(
        model_fn=lambda p, x: tt.decoder_lm_apply(p, x, n_heads=HEADS),
        loss_outer=tt.next_token_loss,
    )


def _jax_rounds_once(monkeypatch):
    """JAX's softmax and GELU computed in (at least) f32 and rounded once,
    as PyTorch's are (module docstring)."""
    softmax, gelu = jax.nn.softmax, jax.nn.gelu

    def up(a):
        return a.astype(jnp.promote_types(a.dtype, jnp.float32))

    monkeypatch.setattr(jax.nn, "softmax", lambda a, axis=-1: softmax(
        up(a), axis=axis).astype(a.dtype))
    monkeypatch.setattr(jax.nn, "gelu", lambda a, approximate=True: gelu(
        up(a), approximate).astype(a.dtype))


def _jax_each_op_rounded(fn, *args):
    """``fn(*args)`` jitted with XLA's excess precision off, so that every
    bf16 op rounds its result as eager PyTorch does."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _jax_lm(d_model, seed):
    jparams = jt.init_decoder_lm(jax.random.PRNGKey(seed), vocab=VOCAB,
                                 d_model=d_model, n_heads=HEADS, n_layers=2,
                                 d_ff=32, max_len=T, dtype=jnp.float32)
    start = np.random.default_rng(seed).integers(0, VOCAB, 4)
    toks = [start]
    for _ in range(T - 1):
        toks.append((5 * toks[-1] + 3) % VOCAB)
    return jparams, params_from_jax(jax.tree_util.tree_map(
        np.asarray, jparams), device="cpu"), np.stack(toks, axis=1)


def test_bf16_forward_matches_jax_bitwise(monkeypatch):
    """d_head 6: the scores rounded to bf16 before the 1/sqrt(6) scale
    differ from scores scaled first, so the order is held here."""
    _jax_rounds_once(monkeypatch)
    jparams, tparams, toks = _jax_lm(24, 7)
    j_out = _jax_each_op_rounded(
        lambda p, x: jt.decoder_lm_apply(p, x, n_heads=HEADS),
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams),
        jnp.asarray(toks))
    t_out = tt.decoder_lm_apply(_cast_floating(tparams, torch.bfloat16),
                                torch.tensor(toks), n_heads=HEADS)
    assert t_out.dtype == torch.bfloat16
    np.testing.assert_array_equal(t_out.float().numpy(),
                                  np.asarray(j_out.astype(jnp.float32)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("curvature_opt", ["ggn", "hessian"])
def test_bf16_matvec_matches_jax(monkeypatch, curvature_opt):
    """The forwards agree bit for bit (above), but the two frameworks'
    derivative rules round at other points, so the bf16 matvecs agree only
    to a part of the bf16 error itself: the port's lies from JAX's within
    half its distance from f32 (0.39 and 0.22 of it measured), and that
    distance is JAX's own within a third."""
    _jax_rounds_once(monkeypatch)
    jparams, tparams, toks = _jax_lm(16, 8)
    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    vs = np.random.default_rng(8).standard_normal((2, tr.dim)).astype(
        np.float32)
    j_fns = jhf.HFModelFns(
        model_fn=lambda p, x: jt.decoder_lm_apply(p, x, n_heads=HEADS),
        loss_outer=jt.next_token_loss)
    cdtypes = (None, "bfloat16")

    def j_run(params, batch, vs):  # both dtypes in one compile
        return [jax.lax.map(j_build(
            j_fns, jhf.HFConfig(curvature_opt=curvature_opt,
                                curvature_dtype=c and jnp.bfloat16),
            jr, params, batch)[2], vs) for c in cdtypes]

    j_out = _jax_each_op_rounded(j_run, jparams, (jnp.asarray(toks),) * 2,
                                 jnp.asarray(vs))
    mvps = {}
    for cdtype, j_mvps in zip(cdtypes, j_out):
        mvps["jax", cdtype] = np.asarray(j_mvps, np.float64)
        t_mvp = _build_matvec_and_grad(
            _lm_fns(), thf.HFConfig(curvature_opt=curvature_opt,
                                    curvature_dtype=cdtype),
            tr, tparams, (torch.tensor(toks),) * 2)[2]
        out = [t_mvp(torch.tensor(v)) for v in vs]
        assert all(o.dtype == torch.float32 for o in out)
        mvps["torch", cdtype] = torch.stack(out).double().numpy()
    gap = _rel(mvps["torch", "bfloat16"], mvps["torch", None])
    jax_gap = _rel(mvps["jax", "bfloat16"], mvps["jax", None])
    assert _rel(mvps["torch", None], mvps["jax", None]) < 1e-5  # f32
    assert gap > 1e-3  # bf16 rounding, not f32's: a cast happened
    assert 0.75 < gap / jax_gap < 1.33
    assert _rel(mvps["torch", "bfloat16"], mvps["jax", "bfloat16"]) < 0.5 * gap
