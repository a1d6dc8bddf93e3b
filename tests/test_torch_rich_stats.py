"""``HFConfig(rich_stats=True)``: the ``HFDetail`` solver trace against the
JAX package's, field by field, and the port's counterparts of
``tests/test_rich_stats.py``: the CG m-history against a NumPy CG oracle
through the full step, the backtracking and line-search traces, the
batched modes, the train loop's stacking and ``format_rich_stats``."""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from test_torch_optimizer import assert_same_step  # noqa: E402


def _problem(seed, N=12):
    jparams = jm.init_mlp(jax.random.PRNGKey(seed), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 7))
    y = rng.standard_normal((N, 3))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jparams, tparams, x, y


def _both_steps(seed, **config):
    jparams, tparams, x, y = _problem(seed)
    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    j_cfg = jhf.HFConfig(**{
        k: jhf.LineSearchConfig(**v) if k == "linesearch" else v
        for k, v in config.items()
    })
    t_cfg = thf.HFConfig(**{
        k: thf.LineSearchConfig(**v) if k == "linesearch" else v
        for k, v in config.items()
    })
    j_step = jhf.make_hf_step(jhf.HFModelFns(jm.mlp_apply, jm.mse_loss),
                              j_cfg, jr)
    t_step = thf.make_hf_step(thf.HFModelFns(tm.mlp_apply, tm.mse_loss),
                              t_cfg, tr)
    _, _, jst = j_step(jparams, jhf.init_state(jr, j_cfg),
                       (jnp.asarray(x), jnp.asarray(y)))
    _, _, tst = t_step(tparams, thf.init_state(tr, t_cfg),
                       (torch.tensor(x), torch.tensor(y)))
    return jst, tst


def _assert_same_detail(td, jd, rtol=1e-10):
    assert tuple(td._fields) == tuple(jd._fields)
    for name in jd._fields:
        t, j = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j), name)
        np.testing.assert_allclose(t, j, rtol=rtol, atol=1e-300,
                                   err_msg=name)


CONFIGS = [
    dict(),
    dict(backtracking_mode="batched", linesearch=dict(mode="batched")),
    dict(linesearch=dict(mode="batched", batch_chunk=3)),
    dict(use_linesearch=False),
    dict(use_linesearch=False, use_cg_backtracking=False,
         compute_final_loss=False),
    dict(adapt_damping=False, use_cg_backtracking=False),
]


@pytest.mark.parametrize("config", CONFIGS)
def test_detail_matches_jax(config):
    jst, tst = _both_steps(1, damping=0.3, cg_max_iter=25, rich_stats=True,
                           **config)
    assert tst.num_cg_iters == int(jst.num_cg_iters)
    assert tst.best_cg_iter == int(jst.best_cg_iter)
    np.testing.assert_allclose(float(tst.lr), float(jst.lr), rtol=1e-10)
    _assert_same_detail(tst.detail, jst.detail)


@pytest.mark.parametrize("config", CONFIGS[:2])
def test_wrapper_steps_with_rich_stats_match_jax(config):
    jparams, tparams, x, y = _problem(2)
    kw = dict(damping=0.3, cg_max_iter=25, rich_stats=True)
    j_ls = jhf.LineSearchConfig(**config.get("linesearch", {}))
    t_ls = thf.LineSearchConfig(**config.get("linesearch", {}))
    mode = config.get("backtracking_mode", "sequential")
    j_opt = jhf.HessianFree(jparams, model_fn=jm.mlp_apply,
                            loss_outer=jm.mse_loss, linesearch=j_ls,
                            backtracking_mode=mode, **kw)
    t_opt = thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                            loss_outer=tm.mse_loss, linesearch=t_ls,
                            backtracking_mode=mode, **kw)
    for _ in range(2):
        j_opt.step((jnp.asarray(x), jnp.asarray(y)))
        t_opt.step((torch.tensor(x), torch.tensor(y)))
        _assert_same_detail(t_opt.last_stats.detail, j_opt.last_stats.detail,
                            rtol=1e-8)
    assert_same_step(t_opt, j_opt, 1e-8)


def _np_cg_m_hist(A, b, max_iter, tol=1e-5):
    """Independent oracle: unpreconditioned Martens-terminated CG's
    m(x_i) = 0.5 x_i^T A x_i - b^T x_i per iteration."""
    x = np.zeros_like(b)
    r = A @ x - b
    m = [0.5 * x @ A @ x - b @ x]
    p = -r
    ry = r @ r
    it = 1
    while True:
        Ap = A @ p
        alpha = ry / (p @ Ap)
        x = x + alpha * p
        r = r + alpha * Ap
        m.append(0.5 * x @ A @ x - b @ x)
        k = max(10, it // 10)
        if k < it and (m[it] - m[it - k]) / (m[it] - m[0]) < 5e-4:
            break
        if it >= max_iter or np.linalg.norm(r) < tol * np.linalg.norm(b):
            break
        ry_new = r @ r
        p = -r + (ry_new / ry) * p
        ry = ry_new
        it += 1
    return np.asarray(m), it


def test_m_hist_matches_numpy_oracle_through_full_step():
    from pytorchhessianfree_tpu_torch.optimizer import _build_matvec_and_grad

    _, params, x, y = _problem(0)
    fns = thf.HFModelFns(tm.mlp_apply, tm.mse_loss)
    config = thf.HFConfig(damping=0.3, cg_max_iter=25, rich_stats=True)
    ravel = thf.TrainableRavel(params)
    batch = (torch.tensor(x), torch.tensor(y))
    _, grad, mvp = _build_matvec_and_grad(fns, config, ravel, params, batch)
    eye = torch.eye(ravel.dim, dtype=torch.float64)
    A = torch.stack([mvp(e) for e in eye]).T.numpy() + 0.3 * np.eye(ravel.dim)
    _, _, stats = thf.make_hf_step(fns, config, ravel)(
        params, thf.init_state(ravel, config), batch)
    m_oracle, iters = _np_cg_m_hist(A, -grad.numpy(), 25)
    assert stats.num_cg_iters == iters
    np.testing.assert_allclose(stats.detail.m_hist[: iters + 1].numpy(),
                               m_oracle, atol=1e-9)


def test_backtracking_and_linesearch_traces():
    _, tst = _both_steps(1, damping=0.3, cg_max_iter=25, rich_stats=True)
    d = tst.detail
    cand, bt = d.cand_iters.numpy(), d.bt_f.numpy()
    assert cand[-1] == tst.num_cg_iters and not np.isnan(bt[-1])
    chosen = (cand == tst.best_cg_iter) & ~np.isnan(bt)
    assert chosen.any()
    np.testing.assert_allclose(bt[chosen][-1], np.nanmin(bt))
    al, fl = d.ls_alphas.numpy(), d.ls_f.numpy()
    tried = ~np.isnan(al)
    assert tried.any() and al[0] == 1.0
    np.testing.assert_allclose(al[tried][-1], float(tst.lr))
    np.testing.assert_allclose(fl[tried][-1], float(tst.final_loss))
    text = thf.format_rich_stats(tst)
    assert "CG m-history" in text and "Backtracking" in text
    assert "<-- chosen" in text and "<-- accepted" in text


def test_batched_modes_trace_consistency():
    """The batched modes choose what the sequential ones choose; where the
    sequential walk evaluated, the batched record holds the same loss."""
    kw = dict(damping=0.3, cg_max_iter=25, rich_stats=True)
    _, st_s = _both_steps(2, **kw)
    _, st_b = _both_steps(2, backtracking_mode="batched",
                          linesearch=dict(mode="batched"), **kw)
    assert st_s.best_cg_iter == st_b.best_cg_iter
    np.testing.assert_allclose(float(st_s.lr), float(st_b.lr), rtol=1e-14)
    bs, bb = st_s.detail.bt_f.numpy(), st_b.detail.bt_f.numpy()
    mask = ~np.isnan(bs)
    np.testing.assert_allclose(bs[mask], bb[mask], rtol=1e-12)


def test_ls_trace_empty_without_linesearch_and_final_slot_recorded():
    _, st = _both_steps(0, damping=0.5, cg_max_iter=20, use_linesearch=False,
                        rich_stats=True)
    assert tuple(st.detail.ls_alphas.shape) == tuple(st.detail.ls_f.shape)
    assert tuple(st.detail.ls_f.shape) == (0,)
    _, st = _both_steps(0, damping=0.5, cg_max_iter=20, use_linesearch=False,
                        use_cg_backtracking=False, compute_final_loss=False,
                        rich_stats=True)
    assert np.isfinite(float(st.detail.bt_f[-1]))  # f(final iterate)
    assert bool(torch.isnan(st.detail.bt_f[:-1]).all())


def test_detail_none_by_default_and_stacked_by_the_train_loop():
    jparams, tparams, x, y = _problem(3)
    fns = thf.HFModelFns(tm.mlp_apply, tm.mse_loss)
    ravel = thf.TrainableRavel(tparams)
    config = thf.HFConfig(damping=0.3, cg_max_iter=15)
    _, _, stats = thf.make_hf_step(fns, config, ravel)(
        tparams, thf.init_state(ravel, config),
        (torch.tensor(x), torch.tensor(y)))
    assert stats.detail is None

    xs, ys = np.stack([x, 0.5 * x]), np.stack([y, y])
    config_r = thf.HFConfig(damping=0.3, cg_max_iter=15, rich_stats=True)
    _, _, stats = thf.make_hf_train_loop(fns, config_r, ravel)(
        tparams, thf.init_state(ravel, config_r),
        (torch.tensor(xs), torch.tensor(ys)))
    assert isinstance(stats.detail, thf.HFDetail)
    assert tuple(stats.detail.m_hist.shape) == (2, 16)
    assert stats.detail.bt_f.shape[0] == 2

    j_cfg = jhf.HFConfig(damping=0.3, cg_max_iter=15, rich_stats=True)
    jr = jhf.TrainableRavel(jparams)
    _, _, j_stats = jhf.make_hf_train_loop(
        jhf.HFModelFns(jm.mlp_apply, jm.mse_loss), j_cfg, jr)(
        jparams, jhf.init_state(jr, j_cfg),
        (jnp.asarray(xs), jnp.asarray(ys)))
    _assert_same_detail(stats.detail, j_stats.detail, rtol=1e-8)


def test_train_steps_history_with_rich_stats():
    _, tparams, x, y = _problem(4)
    opt = thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                          loss_outer=tm.mse_loss, damping=0.3,
                          cg_max_iter=15, rich_stats=True)
    finals = opt.train_steps((torch.tensor(np.stack([x, x])),
                              torch.tensor(np.stack([y, y]))))
    assert opt.history["final_losses"] == finals and len(finals) == 2
    assert opt.last_stats.detail.ls_f.shape[0] == 2


def _port_stats(j):
    """The port's HFStats holding the numbers of a JAX HFStats."""
    def t(a):
        return torch.tensor(np.asarray(a))

    return thf.HFStats(
        init_loss=t(j.init_loss), final_loss=t(j.final_loss),
        damping=t(j.damping), new_damping=t(j.new_damping), rho=t(j.rho),
        cg_reason=int(j.cg_reason), num_cg_iters=int(j.num_cg_iters),
        best_cg_iter=int(j.best_cg_iter), lr=t(j.lr),
        nonpos_curvature=t(j.nonpos_curvature),
        rho_negative=t(j.rho_negative),
        linesearch_failed=bool(j.linesearch_failed),
        not_descent_direction=bool(j.not_descent_direction),
        detail=thf.HFDetail(*(t(f) for f in j.detail)),
    )


@pytest.mark.parametrize("config", CONFIGS)
def test_format_rich_stats_text_matches_jax(config):
    jst, _ = _both_steps(1, damping=0.3, cg_max_iter=25, rich_stats=True,
                         **config)
    assert thf.format_rich_stats(_port_stats(jst)) == jhf.format_rich_stats(
        jst)
    assert thf.format_rich_stats(_port_stats(jst)._replace(detail=None)) == (
        jhf.format_rich_stats(jst._replace(detail=None)))


def test_format_rich_stats_reports_a_failed_linesearch_like_jax():
    jst, _ = _both_steps(1, damping=0.3, cg_max_iter=25, rich_stats=True)
    failed = jst._replace(linesearch_failed=jnp.asarray(True),
                          lr=jnp.asarray(0.0))
    text = jhf.format_rich_stats(failed)
    assert "no alpha accepted" in text
    assert thf.format_rich_stats(_port_stats(failed)) == text


def test_verbose_step_prints_the_detail():
    _, tparams, x, y = _problem(5)
    opt = thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                          loss_outer=tm.mse_loss, damping=0.3,
                          cg_max_iter=15, rich_stats=True, verbose=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        opt.step((torch.tensor(x), torch.tensor(y)))
    out = buf.getvalue()
    assert "[HF step 1]" in out and "CG m-history" in out
    assert thf.format_rich_stats(opt.last_stats) in out
