"""Port ``cg`` against the JAX package's ``cg`` in f64 on the same systems:
same iteration count, reason and curvature flag; ``m`` history, reached
grid rows and the final iterate to rtol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu.ops import cg as jcg  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import cg as tcg  # noqa: E402


def _spd(n, seed, cond=20.0):
    # moderate conditioning: CG's rounding differences between two
    # implementations grow with the condition number once the residual is
    # small (at cond 1e3 they reach 1e-4 within 30 iterations); at cond 20
    # the two solvers agree to ~1e-15
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.geomspace(1.0, cond, n)
    return (q * eigs) @ q.T, rng.standard_normal(n), rng


def _indefinite(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.linspace(-1.0, 4.0, n)
    eigs[np.abs(eigs) < 0.2] = 0.5
    return (q * eigs) @ q.T, rng.standard_normal(n), rng


def _solve_both(a, b, x0=None, diag_m=None, **kw):
    ja, ta = jnp.asarray(a), torch.tensor(a)
    jm = tm = None
    if diag_m is not None:
        jd, td = jnp.asarray(diag_m), torch.tensor(diag_m)
        jm, tm = (lambda v: jd * v), (lambda v: td * v)
    j = jcg.cg(
        lambda v: ja @ v, jnp.asarray(b), M=jm,
        x0=None if x0 is None else jnp.asarray(x0), **kw,
    )
    t = tcg.cg(
        lambda v: ta @ v, torch.tensor(b), M=tm,
        x0=None if x0 is None else torch.tensor(x0), **kw,
    )
    return j, t


def _assert_vec_close(actual, expected, rtol):
    # norm-wise: an entry near zero carries an absolute error set by the
    # vector's scale (CG's rounding feeds back through the directions), so
    # an element-wise rtol would test the entry's magnitude, not the solver
    err = np.linalg.norm(actual - expected)
    assert err <= rtol * np.linalg.norm(expected), (err, rtol)


def _check_same(j, t, rtol=1e-10):
    k = int(j.num_iters)
    assert t.num_iters == k
    assert t.reason == int(j.reason)
    assert bool(t.nonpos_pAp) == bool(j.nonpos_pAp)
    assert t.stored_iters == j.stored_iters
    np.testing.assert_allclose(
        t.m_hist[: k + 1].numpy(), np.asarray(j.m_hist)[: k + 1], rtol=rtol
    )
    _assert_vec_close(t.x.numpy(), np.asarray(j.x), rtol)
    reached = np.asarray(j.reached())
    np.testing.assert_array_equal(t.reached().numpy(), reached)
    for row, want in zip(t.x_buf.numpy()[reached], np.asarray(j.x_buf)[reached]):
        _assert_vec_close(row, want, rtol)
    np.testing.assert_allclose(float(t.m_final), float(j.m_final), rtol=rtol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spd_martens_grid_matches_jax(seed):
    a, b, rng = _spd(40, seed)
    x0 = 0.1 * rng.standard_normal(40) if seed == 2 else None
    j, t = _solve_both(a, b, x0=x0, max_iter=30, martens_conv_crit=True,
                       store_x_at_iters=None)
    _check_same(j, t)


def test_indefinite_saddle_free_matches_jax():
    a, b, _ = _indefinite(40, 3)
    j, t = _solve_both(a, b, max_iter=30, martens_conv_crit=True,
                       store_x_at_iters=None,
                       nonpos_curv_option="saddle-free")
    assert bool(j.nonpos_pAp)
    _check_same(j, t)


def test_indefinite_ignore_flags_nonpos_like_jax():
    a, b, _ = _indefinite(40, 4)
    j, t = _solve_both(a, b, max_iter=12, store_x_at_iters=None)
    _check_same(j, t)


def test_diagonal_preconditioner_matches_jax():
    # badly scaled (diagonal spread 1e3) but well conditioned once Jacobi
    # preconditioned, so the diagonal M is what makes CG converge
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.standard_normal((40, 40)))
    scale = np.sqrt(np.geomspace(1.0, 1e3, 40))
    a = scale[:, None] * ((q * np.geomspace(1.0, 10.0, 40)) @ q.T) * scale
    b = rng.standard_normal(40)
    diag_m = 1.0 / np.diag(a)
    j, t = _solve_both(a, b, diag_m=diag_m, max_iter=30,
                       martens_conv_crit=True, store_x_at_iters=None)
    _check_same(j, t)


@pytest.mark.parametrize(
    "kw",
    [
        dict(max_iter=100, tol=1e-8),  # tolerance stop
        dict(max_iter=100, tol=0.0, atol=1e-6),  # absolute tolerance
        dict(max_iter=7, store_x_at_iters=(0, 3, 5, 99)),  # explicit grid
        dict(max_iter=5, store_x_at_iters=()),  # max_iter, nothing stored
    ],
)
def test_termination_and_storage_variants_match_jax(kw):
    a, b, _ = _spd(20, 6, cond=10.0)
    j, t = _solve_both(a, b, **kw)
    _check_same(j, t)


def test_storing_grid_and_reason_strings_match_jax():
    for max_iter in (1, 10, 50, 250):
        for gamma in (1.1, 1.3, 2.0):
            assert tcg.storing_grid(max_iter, gamma) == jcg.storing_grid(
                max_iter, gamma
            )
    assert len(tcg.storing_grid(50)) == 13
    assert tcg.CG_REASON_STRINGS == jcg.CG_REASON_STRINGS
    with pytest.raises(ValueError):
        tcg.storing_grid(10, 1.0)
    with pytest.raises(ValueError, match="Unknown option"):
        tcg.cg(lambda v: v, torch.ones(3), nonpos_curv_option="clip")


def test_nan_divergence_matches_jax():
    n = 6
    a = np.eye(n)
    a[0, 0] = np.nan
    b = np.ones(n)
    j, t = _solve_both(a, b, max_iter=10)
    assert t.reason == int(j.reason) == tcg.REASON_DIVERGENCE
    assert t.num_iters == int(j.num_iters)


@pytest.mark.parametrize("store_dtype", ["bfloat16", "float16", "float32"])
def test_store_dtype_rounds_only_the_stored_iterates(store_dtype):
    """CGConfig.store_dtype: the iteration is bitwise that of the full
    precision store; rows read back through ``row`` in the iterate's
    dtype, as the JAX package's selection casts them."""
    a, b, _ = _spd(40, 3)
    A, rhs = torch.tensor(a), torch.tensor(b)
    kw = dict(max_iter=30, martens_conv_crit=True, store_x_at_iters=None)
    full = tcg.cg(lambda v: A @ v, rhs, **kw)
    low = tcg.cg(lambda v: A @ v, rhs, store_dtype=store_dtype, **kw)
    assert (low.num_iters, low.reason) == (full.num_iters, full.reason)
    for name in ("x", "m_hist", "nonpos_pAp"):
        assert torch.equal(getattr(low, name), getattr(full, name)), name
    assert low.x_buf.dtype == getattr(torch, store_dtype)
    torch.testing.assert_close(low.x_buf, full.x_buf.to(low.x_buf.dtype),
                               rtol=0, atol=0)
    assert low.row(2).dtype == torch.float64
    assert torch.equal(low.row(2), full.x_buf[2].to(low.x_buf.dtype).double())
    j = jcg.cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
               store_dtype=store_dtype, **kw)
    assert str(j.x_buf.dtype) == store_dtype
    reached = low.reached().numpy()
    np.testing.assert_allclose(low.x_buf.double().numpy()[reached],
                               np.asarray(j.x_buf, np.float64)[reached],
                               rtol=1e-2 if store_dtype != "float32" else 1e-9,
                               atol=1e-3)


def test_unknown_store_dtype_raises():
    with pytest.raises(ValueError, match="store_dtype"):
        tcg.cg(lambda v: v, torch.ones(3, dtype=torch.float64),
               store_dtype="bfloat15")
