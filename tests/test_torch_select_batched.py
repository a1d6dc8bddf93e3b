"""The batched select modes and the exhaustive backtracking against the JAX
package, and the port's counterparts of ``tests/test_select.py``: the
reference's toy example, the final-iterate dedupe, the line search against
a host replay of the reference algorithm, failure, and chunked sweeps."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pytorchhessianfree_tpu.ops import select as jsel  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import cg as tcg  # noqa: E402
from pytorchhessianfree_tpu_torch.ops import select as tsel  # noqa: E402
from test_torch_select import _cg_results, _problem  # noqa: E402

MODES = ["sequential", "batched"]


def _assert_same_backtrack(tb, jb):
    assert tb.best_iter == int(jb.best_iter)
    np.testing.assert_allclose(tb.step.numpy(), np.asarray(jb.step),
                               rtol=1e-10)
    np.testing.assert_allclose(float(tb.f_best), float(jb.f_best),
                               rtol=1e-10)
    np.testing.assert_allclose(float(tb.f_final), float(jb.f_final),
                               rtol=1e-10)
    np.testing.assert_array_equal(np.isnan(tb.f_vals.numpy()),
                                  np.isnan(np.asarray(jb.f_vals)))
    np.testing.assert_allclose(tb.f_vals.numpy(), np.asarray(jb.f_vals),
                               rtol=1e-10)


@pytest.mark.parametrize("quartic", [0.0, 0.01, 0.05, 1.0])
def test_batched_backtracking_matches_jax(quartic):
    h, g, jf, tf = _problem(0, quartic)
    jres, tres = _cg_results(h, g)
    _assert_same_backtrack(
        tsel.cg_efficient_backtracking(tf, tres, mode="batched"),
        jsel.cg_efficient_backtracking(jf, jres, mode="batched"),
    )


@pytest.mark.parametrize("quartic", [0.0, 0.05, 1.0])
def test_exhaustive_backtracking_matches_jax(quartic):
    h, g, jf, tf = _problem(1, quartic)
    jres, tres = _cg_results(h, g)
    _assert_same_backtrack(tsel.cg_backtracking(tf, tres),
                           jsel.cg_backtracking(jf, jres))


@pytest.mark.parametrize("quartic", [0.05, 1.0])
def test_batched_walk_chooses_what_the_sequential_walk_chooses(quartic):
    h, g, _, tf = _problem(2, quartic)
    _, tres = _cg_results(h, g)
    seq = tsel.cg_efficient_backtracking(tf, tres)
    bat = tsel.cg_efficient_backtracking(tf, tres, mode="batched")
    assert bat.best_iter == seq.best_iter
    torch.testing.assert_close(bat.step, seq.step, rtol=0, atol=0)
    # the batched record fills every valid candidate; where the walk
    # evaluated, the values agree
    walked = ~torch.isnan(seq.f_vals)
    torch.testing.assert_close(bat.f_vals[walked], seq.f_vals[walked],
                               rtol=1e-14, atol=0)
    assert int((~torch.isnan(bat.f_vals)).sum()) >= int(walked.sum())


@pytest.mark.parametrize(
    "quartic,init_alpha,direction,chunk",
    [
        (0.0, 1.0, "cg", None),  # accepted at once
        (1.0, 1.0, "cg", None),  # shrinks a few times
        (1.0, 3.0, "cg", 3),  # starts beyond the accepted region, chunked
        (1.0, 3.0, "cg", 7),
        (0.0, 1.0, "ascent", 6),  # not a descent direction: fails
    ],
)
def test_batched_linesearch_matches_jax(quartic, init_alpha, direction,
                                        chunk):
    h, g, jf, tf = _problem(2, quartic)
    jres, _ = _cg_results(h, g)
    step = np.asarray(jres.x) if direction == "cg" else g
    f0 = float(jf(jnp.zeros(len(g))))
    jl = jsel.simple_linesearch(jf, jnp.asarray(g), jnp.asarray(step),
                                jnp.asarray(f0), init_alpha=init_alpha,
                                mode="batched", batch_chunk=chunk)
    tl = tsel.simple_linesearch(tf, torch.tensor(g), torch.tensor(step),
                                torch.tensor(f0), init_alpha=init_alpha,
                                mode="batched", batch_chunk=chunk)
    np.testing.assert_allclose(float(tl.alpha), float(jl.alpha), rtol=1e-10)
    assert tl.failed == bool(jl.failed)
    assert tl.not_descent == bool(jl.not_descent)
    np.testing.assert_allclose(float(tl.f_alpha), float(jl.f_alpha),
                               rtol=1e-10)
    np.testing.assert_array_equal(np.isnan(tl.f_trace.numpy()),
                                  np.isnan(np.asarray(jl.f_trace)))
    np.testing.assert_allclose(tl.alphas.numpy(), np.asarray(jl.alphas),
                               rtol=1e-10)
    np.testing.assert_allclose(tl.f_trace.numpy(), np.asarray(jl.f_trace),
                               rtol=1e-10)


# -- counterparts of tests/test_select.py ------------------------------------


def _toy_cgres():
    """The reference toy steps list [2.0, 1.0, None, 2.7, 2.4, None, None,
    7.3] as a CG result: stored iterations 0, 1, 3, 4, final iterate 7.3
    at iteration 7."""
    return tcg.CGResult(
        x=torch.tensor([7.3], dtype=torch.float64),
        num_iters=7,
        reason=2,
        x_buf=torch.tensor([[2.0], [1.0], [2.7], [2.4]], dtype=torch.float64),
        stored_iters=(0, 1, 3, 4),
        m_hist=torch.zeros(9, dtype=torch.float64),
        nonpos_pAp=torch.tensor(False),
    )


def _tfunc(step):
    return step[0] + 10.0


@pytest.mark.parametrize("mode", MODES)
def test_efficient_backtracking_toy(mode):
    res = tsel.cg_efficient_backtracking(_tfunc, _toy_cgres(), mode=mode)
    # iter 7 (17.3) -> iter 4 (12.4, improves) -> iter 3 (12.7, stop)
    assert res.best_iter == 4
    np.testing.assert_allclose(float(res.f_best), 12.4)
    np.testing.assert_allclose(float(res.step[0]), 2.4)


def test_exhaustive_backtracking_toy():
    res = tsel.cg_backtracking(_tfunc, _toy_cgres())
    assert res.best_iter == 1  # global argmin, f = 11.0
    np.testing.assert_allclose(float(res.f_best), 11.0)


@pytest.mark.parametrize("mode", MODES)
def test_backtracking_dedupes_final_iterate(mode):
    """A grid slot at the final iteration is not evaluated twice; rows past
    num_iters are skipped like the reference's None holes."""
    cgres = tcg.CGResult(
        x=torch.tensor([5.0], dtype=torch.float64),
        num_iters=3,
        reason=2,
        x_buf=torch.tensor([[9.0], [4.0], [5.0], [0.0]], dtype=torch.float64),
        stored_iters=(0, 1, 3, 6),
        m_hist=torch.zeros(7, dtype=torch.float64),
        nonpos_pAp=torch.tensor(False),
    )
    res = tsel.cg_efficient_backtracking(lambda s: s[0], cgres, mode=mode)
    assert res.best_iter == 1
    np.testing.assert_allclose(float(res.f_best), 4.0)


def _replay_reference_linesearch(f, grad, step, f_0, init_alpha, beta, c,
                                 max_iter):
    """Host-side replay of reference linesearch.py:61-103."""
    c_dir = c * float(np.dot(grad, step))
    alpha = init_alpha
    f_alpha = f(init_alpha * step)
    for _ in range(max_iter):
        if f_alpha <= f_0 + alpha * c_dir:
            return alpha, f_alpha
        alpha *= beta
        f_alpha = f(alpha * step)
    return 0.0, f_0


def _quadratic(seed):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((6, 6))
    A = R @ R.T + 0.5 * np.eye(6)
    g = rng.standard_normal(6)
    tA, tg = torch.tensor(A), torch.tensor(g)

    def f_np(d):
        return 0.5 * d @ A @ d + g @ d + 3.0

    def f_t(d):
        return 0.5 * d @ (tA @ d) + tg @ d + 3.0

    return A, g, f_np, f_t


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("mode", MODES)
def test_linesearch_matches_reference_replay(seed, mode):
    A, g, f_np, f_t = _quadratic(seed)
    step = -3.0 * np.linalg.solve(A, g)  # overshoots: backtracking happens
    f_0 = f_np(np.zeros(6))
    exp_alpha, exp_f = _replay_reference_linesearch(
        f_np, g, step, f_0, init_alpha=1.0, beta=0.8, c=1e-2, max_iter=20
    )
    res = tsel.simple_linesearch(f_t, torch.tensor(g), torch.tensor(step),
                                 f_0=torch.tensor(f_0), mode=mode)
    np.testing.assert_allclose(float(res.alpha), exp_alpha, rtol=1e-12)
    np.testing.assert_allclose(float(res.f_alpha), exp_f, rtol=1e-9)
    assert not res.failed and not res.not_descent


@pytest.mark.parametrize("mode", MODES)
def test_linesearch_failure_returns_zero_step(mode):
    g = torch.tensor([1.0, 1.0], dtype=torch.float64)
    res = tsel.simple_linesearch(lambda d: torch.sum(d) + 5.0, g, g,
                                 f_0=torch.tensor(5.0, dtype=torch.float64),
                                 mode=mode)
    assert res.failed and res.not_descent
    assert float(res.alpha) == 0.0 and float(res.f_alpha) == 5.0


@pytest.mark.parametrize("mode", MODES)
def test_linesearch_accepts_immediately(mode):
    g = torch.tensor([2.0, 0.0], dtype=torch.float64)
    step = torch.tensor([-1.0, 0.0], dtype=torch.float64)
    res = tsel.simple_linesearch(lambda d: (d[0] + 1.0) ** 2, g, step,
                                 f_0=torch.tensor(1.0, dtype=torch.float64),
                                 mode=mode)
    assert float(res.alpha) == 1.0 and float(res.f_alpha) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("chunk", [1, 3, 7, 50])
def test_linesearch_chunked_batched_matches(seed, chunk):
    A, g, f_np, f_t = _quadratic(seed)
    step = torch.tensor(-3.0 * np.linalg.solve(A, g))
    f_0 = torch.tensor(f_np(np.zeros(6)))
    full = tsel.simple_linesearch(f_t, torch.tensor(g), step, f_0=f_0,
                                  mode="batched")
    chunked = tsel.simple_linesearch(f_t, torch.tensor(g), step, f_0=f_0,
                                     mode="batched", batch_chunk=chunk)
    assert float(chunked.alpha) == float(full.alpha)
    np.testing.assert_allclose(float(chunked.f_alpha), float(full.f_alpha),
                               rtol=1e-12)
    assert chunked.failed == full.failed
    torch.testing.assert_close(chunked.f_trace, full.f_trace, rtol=1e-14,
                               atol=0)


def test_narrow_resnet_batched_step_matches_jax():
    """The batched modes vmap the whole loss: conv, batch-statistics BN,
    max pooling and cross-entropy over stacked parameter sets."""
    import jax

    import pytorchhessianfree_tpu as jhf
    import pytorchhessianfree_tpu_torch as thf
    from pytorchhessianfree_tpu import models as jm
    from pytorchhessianfree_tpu_torch import models as tm
    from pytorchhessianfree_tpu_torch.convert import params_from_jax

    jparams = jax.jit(lambda k: jm.init_resnet18(
        k, dtype=jnp.float64, width_scale=1 / 16))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((4, 28, 28, 1)), rng.integers(0, 10, 4)
    # few CG iterations: the two frameworks' iterates part by ~1e-6 by the
    # tenth iteration of this badly conditioned system
    kw = dict(damping=1.0, cg_max_iter=5, rich_stats=True,
              backtracking_mode="batched")
    j_opt = jhf.HessianFree(jparams, model_fn=jm.resnet18_apply,
                            loss_outer=jm.cross_entropy_loss,
                            linesearch=jhf.LineSearchConfig(mode="batched"),
                            **kw)
    t_opt = thf.HessianFree(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                        device="cpu"),
        model_fn=tm.resnet18_apply, loss_outer=tm.cross_entropy_loss,
        linesearch=thf.LineSearchConfig(mode="batched", batch_chunk=8), **kw)
    j_opt.step((jnp.asarray(x), jnp.asarray(y)))
    t_opt.step((torch.tensor(x), torch.tensor(y)))
    jd, td = j_opt.last_stats.detail, t_opt.last_stats.detail
    for name in ("bt_f", "ls_f", "ls_alphas"):
        np.testing.assert_array_equal(np.isnan(getattr(td, name).numpy()),
                                      np.isnan(np.asarray(getattr(jd, name))))
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-9)
    assert t_opt.history["best_cg_iters"] == j_opt.history["best_cg_iters"]
    np.testing.assert_allclose(t_opt.history["learning_rates"],
                               j_opt.history["learning_rates"], rtol=1e-12)
