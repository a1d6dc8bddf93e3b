"""CG backtracking and the Armijo line search against the JAX package's
sequential routines, on the same analytic target and the same CG result."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

from pytorchhessianfree_tpu.ops import cg as jcg  # noqa: E402
from pytorchhessianfree_tpu.ops import select as jsel  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import cg as tcg  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import select as tsel  # noqa: E402

N = 30


def _problem(seed, quartic):
    """f(s) = 0.5 s.H s + g.s + quartic * |s|^4: CG solves the quadratic
    part; the quartic term makes late iterates worse, so backtracking picks
    an earlier one."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    h = (q * np.geomspace(0.5, 10.0, N)) @ q.T
    g = rng.standard_normal(N)

    def jf(s):
        return 0.5 * s @ (jnp.asarray(h) @ s) + jnp.asarray(g) @ s + quartic * jnp.sum(s**2) ** 2

    th, tg = torch.tensor(h), torch.tensor(g)

    def tf(s):
        return 0.5 * s @ (th @ s) + tg @ s + quartic * torch.sum(s**2) ** 2

    return h, g, jf, tf


def _cg_results(h, g, max_iter=25):
    jres = jcg.cg(lambda v: jnp.asarray(h) @ v, -jnp.asarray(g),
                  max_iter=max_iter, martens_conv_crit=True,
                  store_x_at_iters=None)
    # the same CG result carried across, so the test isolates selection
    tres = tcg.CGResult(
        x=torch.tensor(np.asarray(jres.x)),
        num_iters=int(jres.num_iters),
        reason=int(jres.reason),
        x_buf=torch.tensor(np.asarray(jres.x_buf)),
        stored_iters=jres.stored_iters,
        m_hist=torch.tensor(np.asarray(jres.m_hist)),
        nonpos_pAp=torch.tensor(bool(jres.nonpos_pAp)),
    )
    return jres, tres


@pytest.mark.parametrize("quartic", [0.0, 0.01, 0.05, 1.0])
def test_backtracking_matches_jax(quartic):
    h, g, jf, tf = _problem(0, quartic)
    jres, tres = _cg_results(h, g)
    jb = jsel.cg_efficient_backtracking(jf, jres, mode="sequential")
    tb = tsel.cg_efficient_backtracking(tf, tres)
    assert tb.best_iter == int(jb.best_iter)
    np.testing.assert_allclose(tb.step.numpy(), np.asarray(jb.step), rtol=1e-14)
    np.testing.assert_allclose(float(tb.f_best), float(jb.f_best), rtol=1e-12)
    np.testing.assert_allclose(float(tb.f_final), float(jb.f_final),
                               rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(tb.f_vals.numpy()),
                                  np.isnan(np.asarray(jb.f_vals)))
    np.testing.assert_allclose(tb.f_vals.numpy(), np.asarray(jb.f_vals),
                               rtol=1e-12)


def test_backtracking_picks_earlier_iterate():
    h, g, jf, tf = _problem(0, 1.0)
    _, tres = _cg_results(h, g)
    tb = tsel.cg_efficient_backtracking(tf, tres)
    assert tb.best_iter < tres.num_iters


def test_backtracking_without_grid_matches_jax():
    h, g, jf, tf = _problem(1, 0.05)
    jres = jcg.cg(lambda v: jnp.asarray(h) @ v, -jnp.asarray(g), max_iter=8,
                  store_x_at_iters=())
    tres = tcg.cg(lambda v: torch.tensor(h) @ v, -torch.tensor(g),
                  max_iter=8, store_x_at_iters=())
    jb = jsel.cg_efficient_backtracking(jf, jres)
    tb = tsel.cg_efficient_backtracking(tf, tres)
    assert tb.best_iter == int(jb.best_iter) == 8


@pytest.mark.parametrize(
    "quartic,init_alpha,direction",
    [
        (0.0, 1.0, "cg"),  # accepted at once
        (1.0, 1.0, "cg"),  # shrinks a few times
        (1.0, 3.0, "cg"),  # starts beyond the accepted region
        (0.0, 1.0, "ascent"),  # not a descent direction: fails
    ],
)
def test_linesearch_matches_jax(quartic, init_alpha, direction):
    h, g, jf, tf = _problem(2, quartic)
    jres, tres = _cg_results(h, g)
    step = np.asarray(jres.x) if direction == "cg" else g
    f0 = float(jf(jnp.zeros(N)))
    jl = jsel.simple_linesearch(jf, jnp.asarray(g), jnp.asarray(step),
                                jnp.asarray(f0), init_alpha=init_alpha)
    tl = tsel.simple_linesearch(tf, torch.tensor(g), torch.tensor(step),
                                torch.tensor(f0), init_alpha=init_alpha)
    assert float(tl.alpha) == float(jl.alpha)
    assert tl.failed == bool(jl.failed)
    assert tl.not_descent == bool(jl.not_descent)
    np.testing.assert_allclose(float(tl.f_alpha), float(jl.f_alpha),
                               rtol=1e-12)
    np.testing.assert_array_equal(tl.alphas.numpy(), np.asarray(jl.alphas))
    np.testing.assert_allclose(tl.f_trace.numpy(), np.asarray(jl.f_trace),
                               rtol=1e-12)
    if direction == "ascent":
        assert tl.failed and tl.not_descent and float(tl.alpha) == 0.0


def test_linesearch_validation_matches_jax():
    z = torch.zeros(3)
    for kwargs in (dict(beta=1.0), dict(c=-1.0), dict(max_iter=0)):
        with pytest.raises(ValueError) as t_err:
            tsel.simple_linesearch(lambda s: s.sum(), z, z, z.sum(), **kwargs)
        with pytest.raises(ValueError) as j_err:
            jsel.simple_linesearch(lambda s: s.sum(), jnp.zeros(3),
                                   jnp.zeros(3), 0.0, **kwargs)
        assert str(t_err.value) == str(j_err.value)
