"""Accumulation parity: the port's ``accumulate`` module and accumulated
step against the JAX package's, in f64.

Accumulated loss, gradient and curvature matvec match JAX's at rtol 1e-10
on ragged lists (chunks of 7 and 8), on stacked data and on the padded
``weighted_fns`` layout; the amortized and per-chunk matvecs agree; the
reduction self-test passes and raises where JAX's does; ``step`` and
``acc_step`` give one trajectory (port against port, atol 1e-4, as the JAX
package's tests/test_optimizer_acc.py); and 3 preconditioned MLP
``acc_step``s match JAX's in every CG decision, with parameters within
rtol 1e-8.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu import accumulate as jacc  # noqa: E402
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu import optimizer as jopt  # noqa: E402
from pytorchhessianfree_tpu_torch import accumulate as tacc  # noqa: E402
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch import optimizer as topt  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
)
from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

EXPONENT = 0.6  # not the default 0.75: a hard-coded exponent fails


def _j_reg(p):
    return 1e-2 * sum(jnp.sum(q**2) for q in jax.tree_util.tree_leaves(p))


def _t_reg(p):
    return 1e-2 * sum(torch.sum(q**2) for q in tree_flatten(p)[0])


def _problem(seed, n=16):
    jparams = jm.init_mlp(jax.random.PRNGKey(seed), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal((n, 7)), rng.standard_normal((n, 3))
    return jparams, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    device="cpu"), x, y


def _per_sample(reduction):
    """Per-sample MSE whose weighted sum is ``mse_loss`` ("mean", with the
    total count) or ``mse_loss_sum`` ("sum")."""

    def make(mse_per_sample):
        def per_sample(o, t):
            ps = mse_per_sample(o, t)
            return ps if reduction == "mean" else ps * o.shape[-1]

        return per_sample

    return make(jm.mse_per_sample), make(tm.mse_per_sample)


def _layout(layout, reduction, x, y):
    """(JAX fns, port fns, JAX data, port data, reduction to accumulate
    with) for one datalist layout of ``x``, ``y`` (16 samples)."""
    j_loss = jm.mse_loss if reduction == "mean" else jm.mse_loss_sum
    t_loss = tm.mse_loss if reduction == "mean" else tm.mse_loss_sum
    j_fns = jhf.HFModelFns(jm.mlp_apply, j_loss, loss_reg=_j_reg)
    t_fns = thf.HFModelFns(tm.mlp_apply, t_loss, loss_reg=_t_reg)
    if layout == "ragged":
        cuts = [(0, 7), (7, 15)]
        j_data = [(jnp.asarray(x[a:b]), jnp.asarray(y[a:b])) for a, b in cuts]
        t_data = [(torch.tensor(x[a:b]), torch.tensor(y[a:b]))
                  for a, b in cuts]
        return j_fns, t_fns, j_data, t_data, reduction
    if layout == "stacked":
        xs, ys = x.reshape(2, 8, 7), y.reshape(2, 8, 3)
        return (j_fns, t_fns, (jnp.asarray(xs), jnp.asarray(ys)),
                (torch.tensor(xs), torch.tensor(ys)), reduction)
    # padded: the ragged chunks of 5, 7 and 4, padded to 7 and weighted
    cuts = [(0, 5), (5, 12), (12, 16)]
    j_ps, t_ps = _per_sample(reduction)
    jx, jy, jw, total = jacc.pad_ragged_datalist(
        [(jnp.asarray(x[a:b]), jnp.asarray(y[a:b])) for a, b in cuts])
    tx, ty, tw, t_total = tacc.pad_ragged_datalist(
        [(torch.tensor(x[a:b]), torch.tensor(y[a:b])) for a, b in cuts])
    assert total == t_total == 16
    for t, j in ((tx, jx), (ty, jy), (tw, jw)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    j_fns = jacc.weighted_fns(jm.mlp_apply, j_ps, total, reduction)
    t_fns = tacc.weighted_fns(tm.mlp_apply, t_ps, total, reduction)
    return j_fns, t_fns, (jx, (jy, jw)), (tx, (ty, tw)), "sum"


@pytest.mark.parametrize("curvature", ["ggn", "hessian"])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("layout", ["ragged", "stacked", "padded"])
def test_acc_loss_grad_and_mvp_match_jax(layout, reduction, curvature):
    jparams, tparams, x, y = _problem(0)
    j_fns, t_fns, j_data, t_data, red = _layout(layout, reduction, x, y)
    jcfg, tcfg = jhf.HFConfig(curvature_opt=curvature), thf.HFConfig(
        curvature_opt=curvature)
    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    v = np.random.default_rng(1).standard_normal(tr.dim)

    np.testing.assert_allclose(
        float(tacc.acc_loss(t_fns, tparams, t_data, red)),
        float(jacc.acc_loss(j_fns, jparams, j_data, red)), rtol=1e-10)
    assert_vec_close(tacc.acc_grad(t_fns, tparams, t_data, red, tr).numpy(),
                     np.asarray(jacc.acc_grad(j_fns, jparams, j_data, red,
                                              jr)), 1e-10)
    t_mvp = tacc.make_acc_mvp(t_fns, tcfg, tparams, t_data, red, tr)
    j_mvp = jacc.make_acc_mvp(j_fns, jcfg, jparams, j_data, red, jr)
    assert_vec_close(t_mvp(torch.tensor(v)).numpy(),
                     np.asarray(j_mvp(jnp.asarray(v))), 1e-10)
    if layout != "ragged" and curvature == "ggn":
        amortized = tacc.make_acc_mvp(t_fns, tcfg, tparams, t_data, red, tr,
                                      amortize=True)
        assert_vec_close(amortized(torch.tensor(v)).numpy(),
                         t_mvp(torch.tensor(v)).numpy(), 1e-12)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_acc_reduce_weighting(reduction):
    data = [(torch.zeros(3, 1), torch.full((3,), 2.0)),
            (torch.zeros(5, 1), torch.full((5,), 10.0))]
    out = tacc.acc_reduce(
        data, lambda x, y: y.mean() if reduction == "mean" else y.sum(),
        reduction)
    expected = 56.0 / 8 if reduction == "mean" else 56.0
    assert float(out) == pytest.approx(expected, rel=1e-7)
    with pytest.raises(ValueError, match="Invalid reduction"):
        tacc.acc_reduce(data, lambda x, y: y.sum(), "meen")
    with pytest.raises(ValueError, match="Invalid reduction"):
        tacc.make_acc_mvp(thf.HFModelFns(tm.mlp_apply, tm.mse_loss),
                          thf.HFConfig(), None, data, "meen", None,
                          amortize=True)


def test_stacked_sniffing_and_concat_match_jax():
    xs = np.arange(24.0).reshape(2, 3, 4)
    ys = np.arange(6.0).reshape(2, 3)
    # a 2-tuple of tensors is stacked, as in JAX; a list is not
    assert tacc._is_stacked((torch.tensor(xs), torch.tensor(ys)))
    assert jacc._is_stacked((jnp.asarray(xs), jnp.asarray(ys)))
    assert not tacc._is_stacked([(torch.tensor(xs[0]), torch.tensor(ys[0]))])
    marked = tacc.StackedData({"a": torch.tensor(xs), "b": torch.ones(2, 3)},
                              (torch.tensor(ys), torch.ones(2, 3)))
    assert tacc._is_stacked(marked) and len(tacc._chunks(marked)) == 2
    cx, (cy, cw) = tacc.concat_datalist(marked)
    assert cx["a"].shape == (6, 4) and cx["b"].shape == (6,)
    np.testing.assert_array_equal(cx["a"].numpy(), xs.reshape(6, 4))
    assert cy.shape == cw.shape == (6,)


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_check_reduction_raises_where_jax_does(seed, reduction):
    jparams, tparams, x, y = _problem(seed)
    loss = {"mean": (jm.mse_loss, tm.mse_loss),
            "sum": (jm.mse_loss_sum, tm.mse_loss_sum)}[reduction]
    j_o = jhf.HessianFree(jparams, model_fn=jm.mlp_apply, loss_outer=loss[0])
    t_o = thf.HessianFree(tparams, model_fn=tm.mlp_apply, loss_outer=loss[1])
    j_data = [(jnp.asarray(x[:7]), jnp.asarray(y[:7])),
              (jnp.asarray(x[7:]), jnp.asarray(y[7:]))]
    t_data = [(torch.tensor(x[:7]), torch.tensor(y[:7])),
              (torch.tensor(x[7:]), torch.tensor(y[7:]))]
    j_o.test_reduction(j_data, reduction)
    t_o.test_reduction(t_data, reduction)
    wrong = "sum" if reduction == "mean" else "mean"
    with pytest.raises(RuntimeError) as j_err:
        j_o.test_reduction(j_data, wrong)
    with pytest.raises(RuntimeError) as t_err:
        t_o.test_reduction(t_data, wrong)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(AssertionError, match="at least two"):
        t_o.test_reduction(t_data[:1], reduction)


def test_check_reduction_on_the_weighted_layout():
    jparams, tparams, x, y = _problem(3)
    _, t_fns, _, t_data, red = _layout("padded", "mean", x, y)
    topt.check_reduction(t_fns, thf.HFConfig(), thf.TrainableRavel(tparams),
                         tparams, t_data, red)


def _port_opt(tparams, curvature):
    return thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                           loss_outer=tm.mse_loss, curvature_opt=curvature,
                           damping=0.5, cg_max_iter=50)


@pytest.mark.parametrize("curvature", ["ggn", "hessian"])
@pytest.mark.parametrize("split", ["single", "ragged", "stacked"])
def test_step_equals_acc_step(split, curvature):
    _, tparams, _, _ = _problem(5)
    opt_a, opt_b = _port_opt(tparams, curvature), _port_opt(tparams,
                                                            curvature)
    for i in range(3):
        _, _, x, y = _problem(100 + i)
        x, y = torch.tensor(x), torch.tensor(y)
        opt_a.step((x, y))
        if split == "single":
            data = [(x, y)]
        elif split == "ragged":
            data = [(x[:7], y[:7]), (x[7:], y[7:])]
        else:
            data = (x.reshape(2, 8, 7), y.reshape(2, 8, 3))
        opt_b.acc_step(data, reduction="mean")
        torch.testing.assert_close(opt_b.ravel.ravel(opt_b.params),
                                   opt_a.ravel.ravel(opt_a.params),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(opt_a.history["init_losses"],
                               opt_b.history["init_losses"], atol=1e-6)
    assert opt_a.history["num_cg_iters"] == opt_b.history["num_cg_iters"]


@functools.lru_cache(maxsize=None)
def _datalists(seed):
    """Independent loss, gradient and matvec datalists (ragged), as numpy."""
    rng = np.random.default_rng(seed)
    x, y = rng.standard_normal((24, 7)), rng.standard_normal((24, 3))
    cut = lambda pairs: [(x[a:b], y[a:b]) for a, b in pairs]  # noqa: E731
    return (cut([(0, 8), (8, 17), (17, 24)]), cut([(0, 12), (12, 24)]),
            cut([(0, 5), (5, 12)]))


@pytest.mark.parametrize("amortize", [False, True])
def test_three_preconditioned_mlp_acc_steps_match_jax(amortize):
    jparams, tparams, _, _ = _problem(7)
    kw = dict(damping=1.0, cg_max_iter=20, precond_exponent=EXPONENT)
    j_o = jhf.HessianFree(jparams, model_fn=jm.mlp_apply,
                          loss_outer=jm.mse_loss, loss_reg=_j_reg, **kw)
    t_o = thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                          loss_outer=tm.mse_loss, loss_reg=_t_reg, **kw)
    for i in range(3):
        lists = _datalists(i)
        if amortize:  # stacked curvature data: one linearization per step
            mvp = np.stack([a for a, _ in lists[1]]), np.stack(
                [b for _, b in lists[1]])
            j_mvp = tuple(jnp.asarray(a) for a in mvp)
            t_mvp = tuple(torch.tensor(a) for a in mvp)
        else:
            j_mvp = [(jnp.asarray(a), jnp.asarray(b)) for a, b in lists[2]]
            t_mvp = [(torch.tensor(a), torch.tensor(b)) for a, b in lists[2]]
        j_loss, j_grad = ([(jnp.asarray(a), jnp.asarray(b)) for a, b in d]
                          for d in lists[:2])
        t_loss, t_grad = ([(torch.tensor(a), torch.tensor(b)) for a, b in d]
                          for d in lists[:2])
        jx, jy = jacc.concat_datalist(j_loss)
        tx, ty = tacc.concat_datalist(t_loss)
        jd = j_o.get_preconditioner(jx, jy, "mean")
        td = t_o.get_preconditioner(tx, ty, "mean")
        assert_vec_close(td.numpy(), np.asarray(jd), 1e-12)
        j_o.acc_step(j_loss, j_grad, j_mvp, precond_diag=jd,
                     mvp_amortize=amortize)
        t_o.acc_step(t_loss, t_grad, t_mvp, precond_diag=td,
                     mvp_amortize=amortize)
    assert_same_step(t_o, j_o, 1e-8)


def test_functional_acc_step_matches_wrapper_and_refuses_diag_ef():
    _, tparams, x, y = _problem(8)
    data = [(torch.tensor(x[:8]), torch.tensor(y[:8])),
            (torch.tensor(x[8:]), torch.tensor(y[8:]))]
    fns = thf.HFModelFns(tm.mlp_apply, tm.mse_loss)
    cfg = thf.HFConfig(damping=0.5, cg_max_iter=20, precond_exponent=EXPONENT)
    ravel = thf.TrainableRavel(tparams, pad_to_multiple=1024)
    diag = torch.rand(ravel.dim, generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    step = thf.make_hf_acc_step(fns, cfg, ravel, precond_exponent=EXPONENT)
    params, state, stats = step(tparams, thf.init_state(ravel, cfg), data,
                                precond_diag=diag)
    opt = thf.HessianFree(tparams, model_fn=tm.mlp_apply,
                          loss_outer=tm.mse_loss, config=cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        final = opt.acc_step(data, precond_diag=diag, test_deterministic=True)
    # the model is deterministic
    assert not any("Non-deterministic" in str(w.message) for w in caught)
    assert final == float(stats.final_loss)
    assert torch.equal(opt.ravel.ravel(opt.params), ravel.ravel(params))
    assert int(state.step_count) == 1

    bad = thf.HFConfig(precond="diag_ef")
    with pytest.raises(ValueError, match="single-batch feature"):
        thf.hf_acc_step(tparams, thf.init_state(ravel, bad), fns=fns,
                        config=bad, ravel=ravel, loss_data=data)
    with pytest.raises(ValueError, match="single-batch feature"):
        jopt.hf_acc_step(None, None, fns=None, config=jhf.HFConfig(
            precond="diag_ef"), ravel=None, loss_data=None)
