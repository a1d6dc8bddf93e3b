"""The train loop and the determinism self-test: the port against the JAX
package, in f64.

``make_hf_train_loop`` (a Python loop over the steps axis here, a
``lax.scan`` in JAX) must take the same CG decisions as JAX's, with and
without the EMA empirical-Fisher preconditioner, when resumed from a state
with ``step_count > 0`` and when the EMA state is threaded across calls;
``HessianFree.train_steps`` keeps one EMA per decay across calls, as JAX's
does.
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
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

CFG = dict(damping=1.0, cg_max_iter=20, precond_exponent=0.6)


@functools.lru_cache(maxsize=None)
def _problem(seed, steps=4):
    jparams = jm.init_mlp(jax.random.PRNGKey(seed), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((steps, 12, 7))
    ys = rng.standard_normal((steps, 12, 3))
    return jparams, xs, ys


def _both(seed):
    jparams, xs, ys = _problem(seed)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    j = (jparams, jhf.HFModelFns(jm.mlp_apply, jm.mse_loss),
         jhf.HFConfig(**CFG), jhf.TrainableRavel(jparams))
    t = (tparams, thf.HFModelFns(tm.mlp_apply, tm.mse_loss),
         thf.HFConfig(**CFG), thf.TrainableRavel(tparams))
    return j, t, xs, ys


def _assert_stats_match(t_stats, j_stats):
    for name in ("num_cg_iters", "cg_reason", "best_cg_iter"):
        np.testing.assert_array_equal(getattr(t_stats, name).numpy(),
                                      np.asarray(getattr(j_stats, name)))
    for name in ("damping", "new_damping", "lr"):
        np.testing.assert_allclose(getattr(t_stats, name).numpy(),
                                   np.asarray(getattr(j_stats, name)),
                                   rtol=1e-12)
    np.testing.assert_allclose(t_stats.final_loss.numpy(),
                               np.asarray(j_stats.final_loss), rtol=1e-8)


@pytest.mark.parametrize("decay", [None, 0.9])
def test_train_loop_matches_jax_and_resumes(decay):
    (jp, jfns, jcfg, jr), (tp, tfns, tcfg, tr), xs, ys = _both(0)
    j_loop = jhf.make_hf_train_loop(jfns, jcfg, jr, precond_exponent=0.6,
                                    precond_ema_decay=decay)
    t_loop = thf.make_hf_train_loop(tfns, tcfg, tr, precond_exponent=0.6,
                                    precond_ema_decay=decay)
    # two calls of two steps, the EMA state threaded through
    j_state, t_state = jhf.init_state(jr, jcfg), thf.init_state(tr, tcfg)
    j_ema = t_ema = None
    for half in (slice(0, 2), slice(2, 4)):
        j_batch = (jnp.asarray(xs[half]), jnp.asarray(ys[half]))
        t_batch = (torch.tensor(xs[half]), torch.tensor(ys[half]))
        if decay is None:
            jp, j_state, j_stats = j_loop(jp, j_state, j_batch)
            tp, t_state, t_stats = t_loop(tp, t_state, t_batch)
        else:
            jp, j_state, j_stats, j_ema = j_loop(jp, j_state, j_batch, j_ema)
            tp, t_state, t_stats, t_ema = t_loop(tp, t_state, t_batch, t_ema)
            assert isinstance(t_ema, thf.EMADiag) and t_ema.decay == decay
            assert bool(j_ema[1]) and t_ema.diag is not None
            assert_vec_close(t_ema.diag.numpy(), np.asarray(j_ema[0]), 1e-10)
        assert t_stats.num_cg_iters.shape == (2,)
        _assert_stats_match(t_stats, j_stats)
    assert int(t_state.step_count) == int(j_state.step_count) == 4
    assert_vec_close(tr.ravel(tp).numpy(), np.asarray(jr.ravel(jp)), 1e-8)

    # resumed from a checkpoint (step_count 7): the first diagonal still
    # seeds the EMA, so the trajectory is the fresh one
    _, (tp0, _, _, _), _, _ = _both(0)
    batch = (torch.tensor(xs[:2]), torch.tensor(ys[:2]))
    fresh = thf.init_state(tr, tcfg)
    resumed = fresh._replace(step_count=torch.tensor(7))
    out_a, out_b = t_loop(tp0, fresh, batch), t_loop(tp0, resumed, batch)
    torch.testing.assert_close(tr.ravel(out_a[0]), tr.ravel(out_b[0]),
                               rtol=0, atol=0)
    assert int(out_b[1].step_count) == 9


def test_train_steps_keeps_one_ema_per_decay_like_jax():
    (jp, _, _, _), (tp, _, _, _), xs, ys = _both(1)
    j_o = jhf.HessianFree(jp, model_fn=jm.mlp_apply, loss_outer=jm.mse_loss,
                          pad_to_multiple=None, **CFG)
    t_o = thf.HessianFree(tp, model_fn=tm.mlp_apply, loss_outer=tm.mse_loss,
                          pad_to_multiple=None, **CFG)
    for decay, half in ((0.9, slice(0, 2)), (0.5, slice(2, 3)),
                        (0.9, slice(3, 4))):
        jf = j_o.train_steps((jnp.asarray(xs[half]), jnp.asarray(ys[half])),
                             precond_ema_decay=decay)
        tf = t_o.train_steps((torch.tensor(xs[half]), torch.tensor(ys[half])),
                             precond_ema_decay=decay)
        np.testing.assert_allclose(tf, jf, rtol=1e-8)
    assert sorted(t_o._ema_states) == [0.5, 0.9]
    for decay in (0.5, 0.9):
        assert_vec_close(t_o._ema_states[decay].diag.numpy(),
                         np.asarray(j_o._ema_states[decay][0]), 1e-10)
    assert len(t_o.history["init_losses"]) == 4
    assert_same_step(t_o, j_o, 1e-8)
    assert t_o.last_stats.num_cg_iters.shape == (1,)


def test_train_steps_without_ema_is_the_step_loop():
    _, (tp, _, _, _), xs, ys = _both(2)
    kw = dict(model_fn=tm.mlp_apply, loss_outer=tm.mse_loss, **CFG)
    opt_a, opt_b = thf.HessianFree(tp, **kw), thf.HessianFree(tp, **kw)
    for i in range(4):
        opt_a.step((torch.tensor(xs[i]), torch.tensor(ys[i])))
    finals = opt_b.train_steps((torch.tensor(xs), torch.tensor(ys)))
    assert finals == opt_a.history["final_losses"]
    assert opt_b.history == opt_a.history
    assert torch.equal(opt_b.ravel.ravel(opt_b.params),
                       opt_a.ravel.ravel(opt_a.params))


def test_ema_loop_needs_the_split_form_and_a_valid_decay():
    params = {"x": torch.ones(3, dtype=torch.float64)}
    ravel = thf.TrainableRavel(params)
    cfg = thf.HFConfig(curvature_opt="hessian")
    direct = thf.HFModelFns(loss_fn=lambda p, b: torch.sum(p["x"] ** 2))
    with pytest.raises(ValueError, match="split model form"):
        thf.make_hf_train_loop(direct, cfg, ravel, precond_ema_decay=0.9)
    split = thf.HFModelFns(model_fn=lambda p, x: x, loss_outer=tm.mse_loss)
    with pytest.raises(ValueError, match="Invalid decay"):
        thf.make_hf_train_loop(split, cfg, ravel, precond_ema_decay=1.5)


def test_check_deterministic_matches_jax():
    (jp, jfns, jcfg, jr), (tp, tfns, tcfg, tr), xs, ys = _both(3)
    j_batch = (jnp.asarray(xs[0]), jnp.asarray(ys[0]))
    t_batch = (torch.tensor(xs[0]), torch.tensor(ys[0]))
    calls = iter(range(100))

    def t_batches():  # a pipeline that yields another batch per call
        return (t_batch[0] + next(calls), t_batch[1])

    j_res = jhf.check_deterministic(
        jfns, jcfg, jr, jp, j_batch, fns_factory=lambda key: jfns,
        batch_factory=lambda: j_batch)
    t_res = thf.check_deterministic(
        tfns, tcfg, tr, tp, t_batch, fns_factory=lambda gen: tfns,
        batch_factory=lambda: t_batch)
    assert t_res == j_res and all(t_res.values())
    assert set(t_res) == {"forward_deterministic", "outputs_deterministic",
                          "mvp_deterministic", "rng_invariant",
                          "data_reproducible"}
    bad = thf.check_deterministic(tfns, tcfg, tr, tp, t_batch,
                                  batch_factory=t_batches)
    assert bad["data_reproducible"] is False


def test_step_with_test_deterministic_warns_and_still_steps():
    _, (tp, _, _, _), xs, ys = _both(4)

    def noisy_model(p, x):  # dropout from the global generator
        return tm.mlp_apply(p, torch.nn.functional.dropout(x, 0.5))

    opt = thf.HessianFree(tp, model_fn=noisy_model, loss_outer=tm.mse_loss,
                          **CFG)
    batch = (torch.tensor(xs[0]), torch.tensor(ys[0]))
    res = opt.test_deterministic(batch)
    assert not res["forward_deterministic"]
    with pytest.warns(UserWarning, match="Non-deterministic"):
        opt.step(batch, test_deterministic=True)
    with pytest.warns(UserWarning, match="Non-deterministic"):
        opt.acc_step([batch, batch], test_deterministic=True)
    assert int(opt.state.step_count) == 2
    quiet = thf.HessianFree(tp, model_fn=tm.mlp_apply,
                            loss_outer=tm.mse_loss, **CFG)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        quiet.step(batch, test_deterministic=True)
    assert not any("Non-deterministic" in str(w.message) for w in caught)
