"""Lanczos, Ritz values and SLQ against the JAX package's, on the same start
vectors and probes, and the port's counterparts of
``tests/test_spectrum.py``: dense oracles, breakdown, quadrature moments,
traces, densities, the padded flat space and the wrapper's
``estimate_spectrum``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.ops import spectrum as jsp  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import mse_loss  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import spectrum as tsp  # noqa: E402
from pytorchhessianfree_tpu_torch.ops.curvature import (  # noqa: E402
    ggnvp_fn,
    hvp_fn,
)
from test_torch_optimizer import (  # noqa: E402
    _j_mlp,
    _j_mse,
    _mlp_problem,
    _t_mlp,
)


def _sym(dim, seed=0):
    """Random symmetric (indefinite) matrix."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((dim, dim))
    return (M + M.T) / 2.0


def _spd(dim, seed=0):
    """R R^T + 1e-3 I (tests/test_utils_hf.py's linear system)."""
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((dim, dim))
    return R @ R.T + 1e-3 * np.eye(dim)


def _v0(dim, seed=0):
    return np.random.default_rng(100 + seed).standard_normal(dim)


def _probes(num, dim, seed=0):
    rng = np.random.default_rng(200 + seed)
    return rng.choice([-1.0, 1.0], size=(num, dim)) / np.sqrt(dim)


def _mv(A):
    tA = torch.tensor(A)
    return lambda v: tA @ v


def _jmv(A):
    jA = jnp.asarray(A)
    return lambda v: jA @ v


@pytest.mark.parametrize("reorth", [True, False])
@pytest.mark.parametrize("k", [4, 10])
def test_lanczos_matches_jax(k, reorth):
    A = _spd(30, seed=k) / 30.0 + np.eye(30)  # well conditioned
    v0 = _v0(30, k)
    j = jsp.lanczos(_jmv(A), jnp.asarray(v0), k, reorth=reorth,
                    keep_basis=True)
    t = tsp.lanczos(_mv(A), torch.tensor(v0), k, reorth=reorth,
                    keep_basis=True)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha),
                               rtol=1e-10)
    np.testing.assert_allclose(t.beta.numpy(), np.asarray(j.beta),
                               rtol=1e-10)
    np.testing.assert_allclose(t.basis.numpy(), np.asarray(j.basis),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_full_krylov_ritz_matches_jax_and_dense(seed):
    dim = 12
    A = _sym(dim, seed)
    v0 = _v0(dim, seed)
    t = tsp.ritz(_mv(A), torch.tensor(v0), num_iters=dim)
    j = jsp.ritz(_jmv(A), jnp.asarray(v0), num_iters=dim)
    evals = np.linalg.eigvalsh(A)[::-1]
    np.testing.assert_allclose(t.values.numpy(), np.asarray(j.values),
                               rtol=1e-8)
    np.testing.assert_allclose(t.values.numpy(), evals, rtol=1e-8)
    np.testing.assert_allclose(t.weights.numpy(), np.asarray(j.weights),
                               rtol=1e-8, atol=1e-14)
    assert float(t.residual_bounds.max()) < 1e-8
    np.testing.assert_allclose(float(t.weights.sum()), 1.0, atol=1e-12)


def test_slq_nodes_and_weights_match_jax():
    dim, k = 24, 6
    A = _spd(dim, seed=3) / dim + 0.5 * np.eye(dim)
    probes = _probes(5, dim, 3)
    for reorth in (False, True):
        tn, tw = tsp.slq(_mv(A), torch.tensor(probes), k, reorth=reorth)
        jn, jw = jsp.slq(_jmv(A), jnp.asarray(probes), k, reorth=reorth)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-8)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-8,
                                   atol=1e-14)
        np.testing.assert_allclose(tw.sum(dim=1).numpy(), 1.0, atol=1e-12)


def test_extremal_ritz_converge_first():
    dim = 60
    A = _spd(dim, seed=3)
    res = tsp.ritz(_mv(A), torch.tensor(_v0(dim, 3)), num_iters=20)
    evals = np.linalg.eigvalsh(A)
    err_max = abs(float(res.values[0]) - evals[-1])
    err_min = abs(float(res.values[-1]) - evals[0])
    assert err_max <= float(res.residual_bounds[0]) + 1e-9
    assert err_max < 1e-6 * evals[-1]
    assert float(res.values[-1]) >= evals[0] - 1e-12
    assert err_min < 1e-2 * evals[-1]


def test_negative_curvature_detected():
    dim = 40
    A = _sym(dim, seed=5)
    res = tsp.ritz(_mv(A), torch.tensor(_v0(dim, 5)), num_iters=25)
    lam_min = np.linalg.eigvalsh(A)[0]
    assert lam_min < 0.0 and float(res.values[-1]) < 0.0
    assert abs(float(res.values[-1]) - lam_min) < 1e-3 * abs(lam_min)


def test_lanczos_tridiagonal_similarity():
    """V A V^T == T and V V^T == I for the stored basis."""
    dim, k = 15, 10
    A = _sym(dim, seed=7)
    res = tsp.lanczos(_mv(A), torch.tensor(_v0(dim, 7)), k, keep_basis=True)
    V = res.basis.numpy()
    assert V.shape == (k, dim)
    np.testing.assert_allclose(V @ V.T, np.eye(k), atol=1e-10)
    off = res.beta[:-1].numpy()
    T_expect = np.diag(res.alpha.numpy()) + np.diag(off, 1) + np.diag(off, -1)
    np.testing.assert_allclose(V @ A @ V.T, T_expect, atol=1e-9)


def test_breakdown_spurious_zeros_have_zero_weight():
    """A start vector in a 3-dim invariant subspace: Lanczos breaks down at
    j = 3; the trailing Ritz pairs are zeros of weight zero."""
    dim, k = 8, 6
    evals = np.array([5.0, 2.0, -1.0, 9.0, 9.5, 7.7, 3.3, 0.4])
    rng = np.random.default_rng(11)
    Q, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    A = (Q * evals) @ Q.T
    v0 = Q[:, 0] + 0.5 * Q[:, 1] - 0.25 * Q[:, 2]
    res = tsp.ritz(_mv(A), torch.tensor(v0), num_iters=k)
    jres = jsp.ritz(_jmv(A), jnp.asarray(v0), num_iters=k)
    w, vals = res.weights.numpy(), res.values.numpy()
    live = w > 1e-12
    assert live.sum() == 3
    np.testing.assert_allclose(np.sort(vals[live]), [-1.0, 2.0, 5.0],
                               atol=1e-9)
    np.testing.assert_allclose(vals[~live], 0.0, atol=1e-12)
    np.testing.assert_allclose(w.sum(), 1.0, atol=1e-12)
    np.testing.assert_allclose(vals, np.asarray(jres.values), atol=1e-9)


def test_slq_moments_exact_to_degree_2k_minus_1():
    """sum_i w_i theta_i^m == v^T A^m v for every m <= 2k - 1."""
    dim, k = 10, 4
    A = _sym(dim, seed=2)
    probes = _probes(3, dim, 0)
    nodes, weights = tsp.slq(_mv(A), torch.tensor(probes), num_iters=k,
                             reorth=True)
    for p in range(probes.shape[0]):
        v = probes[p]
        Amv = v
        for m in range(2 * k):
            quad = float(torch.sum(weights[p] * nodes[p] ** m))
            np.testing.assert_allclose(quad, v @ Amv, rtol=1e-9, atol=1e-9)
            Amv = A @ Amv


def test_slq_trace_exact_in_expectation_and_converges():
    dim = 64
    A = _spd(dim, seed=9)
    probes = _probes(128, dim, 1)
    nodes, weights = tsp.slq(_mv(A), torch.tensor(probes), num_iters=8)
    est = float(tsp.slq_trace(nodes, weights, dim))
    manual = dim * float(np.mean(np.einsum("pi,ij,pj->p", probes, A, probes)))
    np.testing.assert_allclose(est, manual, rtol=1e-9)
    assert abs(est - np.trace(A)) < 0.05 * np.trace(A)


def test_slq_trace_of_function_matches_jax():
    dim = 8
    A = _sym(dim, seed=4) * 0.3
    probes = _probes(64, dim, 2)
    nodes, weights = tsp.slq(_mv(A), torch.tensor(probes), num_iters=dim,
                             reorth=True)
    est = float(tsp.slq_trace(nodes, weights, dim, f=torch.exp))
    exact = float(np.sum(np.exp(np.linalg.eigvalsh(A))))
    np.testing.assert_allclose(est, exact, rtol=0.05)
    j_est = float(jsp.slq_trace(jnp.asarray(nodes.numpy()),
                                jnp.asarray(weights.numpy()), dim, f=jnp.exp))
    np.testing.assert_allclose(est, j_est, rtol=1e-12)


def test_slq_density_normalized_localized_and_matches_jax():
    dim = 32
    A = _spd(dim, seed=6)
    evals = np.linalg.eigvalsh(A)
    lo, hi = evals[0], evals[-1]
    grid = torch.linspace(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), 400,
                          dtype=torch.float64)
    nodes, weights = tsp.slq(_mv(A), torch.tensor(_probes(16, dim, 3)),
                             num_iters=12)
    sigma = 0.05 * (hi - lo)
    dens = tsp.slq_density(nodes, weights, grid, sigma=sigma)
    np.testing.assert_allclose(float(torch.trapezoid(dens, grid)), 1.0,
                               atol=0.02)
    far = torch.linspace(hi + 0.3 * (hi - lo), hi + 0.6 * (hi - lo), 50,
                         dtype=torch.float64)
    dens_far = tsp.slq_density(nodes, weights, far, sigma=sigma)
    assert float(dens_far.max()) < 1e-3 * float(dens.max())
    j_dens = jsp.slq_density(jnp.asarray(nodes.numpy()),
                             jnp.asarray(weights.numpy()),
                             jnp.asarray(grid.numpy()), sigma)
    np.testing.assert_allclose(dens.numpy(), np.asarray(j_dens), rtol=1e-12,
                               atol=1e-300)


# -- through the curvature operators and the padded flat space ---------------


def _flat_curvature(seed, which, pad_to_multiple=None):
    params, x, y = _mlp_problem(seed)
    tparams = params_from_jax(params, device="cpu")
    x, y = torch.tensor(x), torch.tensor(y)
    ravel = thf.TrainableRavel(tparams, pad_to_multiple=pad_to_multiple)
    if which == "hessian":
        _, _, mvp_tree = hvp_fn(lambda p: mse_loss(_t_mlp(p, x), y), tparams)
    else:
        _, _, _, mvp_tree = ggnvp_fn(lambda p: _t_mlp(p, x),
                                     lambda o: mse_loss(o, y), tparams)

    def mvp(v):
        return ravel.ravel(mvp_tree(ravel.unravel(v)))

    return ravel, mvp, tparams, x, y


def _dense(mvp, n, dim):
    eye = torch.eye(dim, dtype=torch.float64)
    return torch.stack([mvp(eye[i]) for i in range(n)])[:, :n]


@pytest.mark.parametrize("which", ["hessian", "ggn"])
def test_ritz_matches_dense_curvature(which):
    ravel, mvp, *_ = _flat_curvature(0, which)
    n = ravel.dim
    evals = np.linalg.eigvalsh(_dense(mvp, n, n).numpy())
    res = tsp.ritz(mvp, torch.tensor(_v0(n, 1)), num_iters=min(n, 40))
    np.testing.assert_allclose(float(res.values[0]), evals[-1], rtol=1e-6,
                               atol=1e-10)
    if which == "ggn":
        assert float(res.values[-1]) >= -1e-10


def test_padded_space_is_transparent():
    ravel_u, mvp_u, *_ = _flat_curvature(2, "ggn")
    ravel_p, mvp_p, *_ = _flat_curvature(2, "ggn", pad_to_multiple=64)
    n, npad = ravel_u.dim, ravel_p.dim
    assert npad > n and npad % 64 == 0
    probes = tsp.normalized_probes(torch.Generator().manual_seed(5), 1, n,
                                   torch.float64, pad_to=npad)
    assert tuple(probes.shape) == (1, npad)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(probes[0])),
                               1.0, atol=1e-12)
    r_u = tsp.ritz(mvp_u, probes[0, :n], num_iters=12)
    r_p = tsp.ritz(mvp_p, probes[0], num_iters=12)
    np.testing.assert_allclose(r_p.values.numpy(), r_u.values.numpy(),
                               atol=1e-8)
    np.testing.assert_allclose(r_p.weights.numpy(), r_u.weights.numpy(),
                               atol=1e-8)


def _wrappers(seed):
    params, x, y = _mlp_problem(seed)
    j_opt = jhf.HessianFree(jax.tree_util.tree_map(jnp.asarray, params),
                            model_fn=_j_mlp, loss_outer=_j_mse)
    t_opt = thf.HessianFree(params_from_jax(params, device="cpu"),
                            model_fn=_t_mlp, loss_outer=mse_loss)
    return (j_opt, (jnp.asarray(x), jnp.asarray(y)),
            t_opt, (torch.tensor(x), torch.tensor(y)))


@pytest.mark.parametrize("curvature", [None, "hessian"])
def test_wrapper_estimate_spectrum_matches_jax_and_dense(curvature):
    """num_iters = n (39 parameters, padded to 1024): the full Krylov
    space, so the Ritz values are the operator's eigenvalues whatever the
    start vector, and the live matvec is the step's (GGN, or the Hessian
    by override)."""
    j_opt, j_batch, t_opt, t_batch = _wrappers(3)
    n = t_opt.ravel.unpadded_dim
    assert t_opt.ravel.dim > n
    mvp = t_opt._live_matvec(t_batch, curvature)
    evals = np.linalg.eigvalsh(_dense(mvp, n, t_opt.ravel.dim).numpy())
    t_res = t_opt.estimate_spectrum(t_batch, num_iters=n,
                                    curvature=curvature)
    j_res = j_opt.estimate_spectrum(j_batch, num_iters=n,
                                    curvature=curvature)
    np.testing.assert_allclose(float(t_res.values[0]), evals[-1], rtol=1e-6)
    np.testing.assert_allclose(float(t_res.values[0]),
                               float(j_res.values[0]), rtol=1e-6)
    if curvature is None:
        assert float(t_res.values[-1]) >= -1e-10  # the GGN is PSD


def test_wrapper_slq_trace_matches_dense_trace():
    _, _, t_opt, t_batch = _wrappers(3)
    n = t_opt.ravel.unpadded_dim
    G = _dense(t_opt._live_matvec(t_batch, None), n, t_opt.ravel.dim)
    res, (nodes, weights) = t_opt.estimate_spectrum(
        t_batch, num_iters=min(n, 20), num_probes=16)
    assert tuple(nodes.shape) == (16, min(n, 20))
    est = float(tsp.slq_trace(nodes, weights, n))
    tr = float(torch.trace(G))
    assert abs(est - tr) < 0.2 * tr
    assert float(res.values[0]) > 0


def test_normalized_probes_shapes_and_errors_match_jax():
    probes = tsp.normalized_probes(torch.Generator().manual_seed(0), 4, 10,
                                   torch.float64)
    assert tuple(probes.shape) == (4, 10)
    np.testing.assert_allclose(probes.abs().numpy(), 1.0 / np.sqrt(10.0),
                               atol=1e-12)
    with pytest.raises(ValueError) as t_err:
        tsp.normalized_probes(torch.Generator(), 2, 10, torch.float64,
                              pad_to=5)
    with pytest.raises(ValueError) as j_err:
        jsp.normalized_probes(jax.random.PRNGKey(0), 2, 10, jnp.float64,
                              pad_to=5)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="num_iters"):
        tsp.lanczos(lambda v: v, torch.ones(3), 0)


def test_tridiag_eigh_matches_dense_and_jax():
    alpha = np.array([1.0, 2.0, 3.0])
    beta = np.array([0.5, 0.25, 0.9])  # beta[-1] unused
    theta, Y = tsp.tridiag_eigh(torch.tensor(alpha), torch.tensor(beta))
    j_theta, _ = jsp.tridiag_eigh(jnp.asarray(alpha), jnp.asarray(beta))
    T = np.diag(alpha) + np.diag(beta[:2], 1) + np.diag(beta[:2], -1)
    np.testing.assert_allclose(theta.numpy(), np.linalg.eigvalsh(T),
                               atol=1e-12)
    np.testing.assert_allclose(theta.numpy(), np.asarray(j_theta),
                               rtol=1e-12)
    np.testing.assert_allclose((Y @ Y.T).numpy(), np.eye(3), atol=1e-12)


def test_slq_trace_survives_last_bit_noise_that_moves_its_nodes():
    """On a narrow ResNet's badly conditioned GGN, a 1e-15 relative
    perturbation of the matvec moves SLQ's nodes (no reorthogonalization)
    far beyond it within 12 iterations, while the trace (the first Lanczos
    coefficient) and the reorthogonalized Ritz values hold: compare traces,
    not nodes, across devices."""
    from pytorchhessianfree_tpu_torch.models import (
        cross_entropy_loss,
        init_resnet18,
        resnet18_apply,
    )

    gen = torch.Generator().manual_seed(1)
    params = init_resnet18(gen, width_scale=1 / 16, dtype=torch.float64)
    x = torch.randn((4, 28, 28, 1), generator=gen, dtype=torch.float64)
    y = torch.randint(0, 10, (4,), generator=gen)
    opt = thf.HessianFree(params, model_fn=resnet18_apply,
                          loss_outer=cross_entropy_loss)
    mvp = opt._live_matvec((x, y), None)
    noise = torch.Generator().manual_seed(5)

    def noisy(v):
        out = mvp(v)
        return out * (1 + 1e-15 * torch.randn(out.shape, generator=noise,
                                              dtype=out.dtype))

    probes = opt._probes(4, None, 3)
    clean = [tsp.lanczos(mvp, p, 12, reorth=False) for p in probes[1:]]
    moved = [tsp.lanczos(noisy, p, 12, reorth=False) for p in probes[1:]]
    shift = max(float(((a.alpha - b.alpha).abs() / a.alpha.abs()).max())
                for a, b in zip(clean, moved))
    assert shift > 1e-8, shift
    for a, b in zip(clean, moved):
        np.testing.assert_allclose(float(b.alpha[0]), float(a.alpha[0]),
                                   rtol=1e-13)
    r_clean = tsp.ritz(mvp, probes[0], 12)
    r_moved = tsp.ritz(noisy, probes[0], 12)
    np.testing.assert_allclose(r_moved.values.numpy(), r_clean.values.numpy(),
                               rtol=1e-9, atol=1e-9)
