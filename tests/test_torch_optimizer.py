"""The slice as a whole: the port's Hessian-free step against the JAX
package's ``make_hf_step`` on the same weights and batch, in f64.

CG iteration counts, termination reasons, the chosen backtracking iterate
and the damping decisions must match exactly.  Losses and parameters use
per-step tolerances that grow with the step, as in
tests/test_cross_framework.py: the two frameworks sum in different orders,
and the CG warm start feeds each step's last-bit differences into the next
step's solve, which amplifies them geometrically.
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.models import (  # noqa: E402
    cross_entropy_loss as j_ce,
    init_resnet18 as j_init_resnet,
    resnet18_apply as j_resnet,
)
from pytorchhessianfree_tpu_torch.convert import (  # noqa: E402
    params_from_jax,
    state_from_jax,
)
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    cross_entropy_loss,
    init_mlp,
    mlp_apply,
    mse_loss,
    resnet18_apply,
)

SIZES = (5, 4, 3)
LOSS_RTOL = [1e-9, 1e-6, 1e-4]
PARAM_ATOL = [1e-6, 1e-5, 1e-3]


def _mlp_problem(seed):
    """The tanh MLP of tests/test_cross_framework.py."""
    rng = np.random.default_rng(seed)
    params = {
        f"l{i}": {
            "w": rng.standard_normal((SIZES[i], SIZES[i + 1]))
            / np.sqrt(SIZES[i]),
            "b": rng.standard_normal((SIZES[i + 1],)) * 0.1,
        }
        for i in range(len(SIZES) - 1)
    }
    x = rng.standard_normal((12, SIZES[0]))
    y = rng.standard_normal((12, SIZES[-1]))
    return params, x, y


def _j_mlp(p, inputs):
    h = jnp.tanh(inputs @ p["l0"]["w"] + p["l0"]["b"])
    return h @ p["l1"]["w"] + p["l1"]["b"]


def _t_mlp(p, inputs):
    h = torch.tanh(inputs @ p["l0"]["w"] + p["l0"]["b"])
    return h @ p["l1"]["w"] + p["l1"]["b"]


def _j_mse(o, t):
    return jnp.mean((o - t) ** 2)


def assert_vec_close(actual, expected, rtol):
    """Norm-wise relative closeness of two flat numpy vectors."""
    err = np.linalg.norm(actual - expected)
    assert err <= rtol * np.linalg.norm(expected), (err, rtol)


def assert_same_step(t_opt, j_opt, param_rtol):
    """Two ``HessianFree`` wrappers, the port's and JAX's, after the same
    steps: identical CG iterations, reasons, best iterates and dampings,
    and parameters within ``param_rtol`` (norm-wise)."""
    th, jh = t_opt.history, j_opt.history
    for key in ("num_cg_iters", "cg_reasons", "best_cg_iters"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["dampings"], jh["dampings"], rtol=1e-12)
    np.testing.assert_allclose(float(t_opt.state.damping),
                               float(j_opt.state.damping), rtol=1e-12)
    np.testing.assert_allclose(th["final_losses"], jh["final_losses"],
                               rtol=param_rtol)
    assert_vec_close(t_opt.ravel.ravel(t_opt.params).numpy(),
                     np.asarray(j_opt.ravel.ravel(j_opt.params)), param_rtol)


def _run_both(j_fns, t_fns, j_cfg, t_cfg, jparams, tparams, j_batch, t_batch,
              steps, trainable=None):
    jr = jhf.TrainableRavel(jparams, trainable)
    tr = thf.TrainableRavel(tparams, trainable)
    j_step = jhf.make_hf_step(j_fns, j_cfg, jr)
    t_step = thf.make_hf_step(t_fns, t_cfg, tr)
    js, ts = jhf.init_state(jr, j_cfg), thf.init_state(tr, t_cfg)
    for i in range(steps):
        jparams, js, jst = j_step(jparams, js, j_batch)
        tparams, ts, tst = t_step(tparams, ts, t_batch)
        assert tst.num_cg_iters == int(jst.num_cg_iters), i
        assert tst.cg_reason == int(jst.cg_reason), i
        assert tst.best_cg_iter == int(jst.best_cg_iter), i
        assert bool(tst.nonpos_curvature) == bool(jst.nonpos_curvature)
        assert tst.linesearch_failed == bool(jst.linesearch_failed)
        # damping decisions (discrete x3/2, x2/3 choices) in lockstep
        np.testing.assert_allclose(float(ts.damping), float(js.damping),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(tst.lr), float(jst.lr), rtol=1e-12)
        np.testing.assert_allclose(float(tst.init_loss),
                                   float(jst.init_loss), rtol=LOSS_RTOL[i])
        np.testing.assert_allclose(float(tst.final_loss),
                                   float(jst.final_loss), rtol=LOSS_RTOL[i])
        np.testing.assert_allclose(
            tr.ravel(tparams).numpy(), np.asarray(jr.ravel(jparams)),
            atol=PARAM_ATOL[i], rtol=1e-3,
        )
        np.testing.assert_allclose(ts.x0.numpy(), np.asarray(js.x0),
                                   atol=PARAM_ATOL[i], rtol=1e-3)
        assert int(ts.step_count) == int(js.step_count) == i + 1
    return tparams, ts


@pytest.mark.parametrize("seed", [0, 1])
def test_three_mlp_steps_match_jax(seed):
    params, x, y = _mlp_problem(seed)
    _run_both(
        jhf.HFModelFns(model_fn=_j_mlp, loss_outer=_j_mse),
        thf.HFModelFns(model_fn=_t_mlp, loss_outer=mse_loss),
        jhf.HFConfig(damping=0.1, cg_max_iter=30),
        thf.HFConfig(damping=0.1, cg_max_iter=30),
        jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params, device="cpu"),
        (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x), torch.tensor(y)),
        steps=3,
    )


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(curvature_opt="hessian"),
        dict(use_cg_backtracking=False, use_linesearch=False),
        dict(adapt_damping=False, lr=0.5),
        dict(cg=dict(nonpos_curv_option="saddle-free")),
    ],
)
def test_mlp_step_variants_match_jax(kwargs):
    # damping 1.0 keeps the damped system well conditioned, so CG's
    # rounding differences between the frameworks stay near 1e-15 (at
    # damping 0.1 this problem's final iterates already differ by 4e-8)
    params, x, y = _mlp_problem(2)
    j_kwargs, t_kwargs = dict(kwargs), dict(kwargs)
    if "cg" in kwargs:
        j_kwargs["cg"] = jhf.CGConfig(**kwargs["cg"])
        t_kwargs["cg"] = thf.CGConfig(**kwargs["cg"])
    _run_both(
        jhf.HFModelFns(model_fn=_j_mlp, loss_outer=_j_mse),
        thf.HFModelFns(model_fn=_t_mlp, loss_outer=mse_loss),
        jhf.HFConfig(damping=1.0, cg_max_iter=20, **j_kwargs),
        thf.HFConfig(damping=1.0, cg_max_iter=20, **t_kwargs),
        jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params, device="cpu"),
        (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x), torch.tensor(y)),
        steps=2,
    )


def test_mlp_regularized_and_frozen_match_jax():
    params, x, y = _mlp_problem(3)
    coeff = 5e-3

    def j_reg(p):
        return 0.5 * coeff * sum(
            jnp.sum(q**2) for q in jax.tree_util.tree_leaves(p)
        )

    def t_reg(p):
        return 0.5 * coeff * sum(
            torch.sum(q**2) for q in thf.utils.flatten.tree_flatten(p)[0]
        )

    trainable = {"l0": {"w": False, "b": False}, "l1": {"w": True, "b": True}}
    tparams, _ = _run_both(
        jhf.HFModelFns(model_fn=_j_mlp, loss_outer=_j_mse, loss_reg=j_reg),
        thf.HFModelFns(model_fn=_t_mlp, loss_outer=mse_loss, loss_reg=t_reg),
        jhf.HFConfig(damping=0.1, cg_max_iter=20),
        thf.HFConfig(damping=0.1, cg_max_iter=20),
        jax.tree_util.tree_map(jnp.asarray, params), params_from_jax(params, device="cpu"),
        (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x), torch.tensor(y)),
        steps=2, trainable=trainable,
    )
    # frozen leaves are bit-identical after the steps
    np.testing.assert_array_equal(tparams["l0"]["w"].numpy(),
                                  params["l0"]["w"])


def test_two_narrow_resnet_steps_match_jax():
    init = jax.jit(lambda key: j_init_resnet(key, dtype=jnp.float64,
                                             width_scale=1 / 16))
    jparams = init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 28, 28, 1))
    y = rng.integers(0, 10, 4)
    _run_both(
        jhf.HFModelFns(model_fn=j_resnet, loss_outer=j_ce),
        thf.HFModelFns(model_fn=resnet18_apply,
                       loss_outer=cross_entropy_loss),
        jhf.HFConfig(damping=1.0, cg_max_iter=10),
        thf.HFConfig(damping=1.0, cg_max_iter=10),
        jparams,
        params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu"),
        (jnp.asarray(x), jnp.asarray(y)), (torch.tensor(x), torch.tensor(y)),
        steps=2,
    )


def test_hessian_free_wrapper_history_and_state_dict():
    params, x, y = _mlp_problem(4)
    batch = (torch.tensor(x), torch.tensor(y))
    opt = thf.HessianFree(params_from_jax(params, device="cpu"), model_fn=_t_mlp,
                          loss_outer=mse_loss, damping=0.1, cg_max_iter=20,
                          verbose=True)
    assert opt.ravel.dim == 1024  # 35 parameters padded to 1024
    buf = io.StringIO()
    with redirect_stdout(buf):
        losses = [opt.step(batch) for _ in range(3)]
    assert buf.getvalue().count("[HF step") == 3
    h = opt.history
    assert h["final_losses"] == losses
    assert losses[-1] < h["init_losses"][0]
    assert all(r in thf.CG_REASON_STRINGS.values() for r in h["cg_reasons"])
    assert len(h["num_cg_iters"]) == 3 and opt.last_stats.detail is None

    sd = opt.state_dict()
    assert sd["step_count"] == 3
    fresh = thf.HessianFree(params_from_jax(params, device="cpu"), model_fn=_t_mlp,
                            loss_outer=mse_loss, damping=0.1, cg_max_iter=20)
    fresh.load_state_dict(sd)
    for a, b in zip(fresh.state, opt.state):
        assert torch.equal(a, b)
    assert fresh.history == h
    sd["history"]["init_losses"].append(0.0)
    assert len(opt.history["init_losses"]) == 3  # snapshot is a copy

    # a JAX state carries over too
    st = state_from_jax(np.asarray(opt.state.x0), 0.25, 7, device="cpu")
    assert float(st.damping) == 0.25 and int(st.step_count) == 7
    assert torch.equal(st.x0, opt.state.x0)


def test_wrapper_refuses_what_is_not_ported():
    params, x, y = _mlp_problem(5)
    opt = thf.HessianFree(params_from_jax(params, device="cpu"), model_fn=_t_mlp,
                          loss_outer=mse_loss)
    batch = (torch.tensor(x), torch.tensor(y))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        thf.HessianFree(params_from_jax(params, device="cpu"), model_fn=_t_mlp,
                        loss_outer=mse_loss, mesh=object())
    with pytest.raises(ValueError, match="either M or precond_diag"):
        opt.step(batch, M=lambda v: v, precond_diag=torch.ones(opt.ravel.dim))
    with pytest.raises(ValueError, match="model_fn"):
        thf.HessianFree(params_from_jax(params, device="cpu"))
    with pytest.raises(ValueError, match="either config"):
        thf.HessianFree(params_from_jax(params, device="cpu"), model_fn=_t_mlp,
                        loss_outer=mse_loss, config=thf.HFConfig(), lr=0.5)


def test_init_mlp_trains_with_cross_entropy():
    gen = torch.Generator().manual_seed(0)
    params = init_mlp(gen, (6, 8, 3), dtype=torch.float64)
    assert [tuple(l["w"].shape) for l in params["layers"]] == [(6, 8), (8, 3)]
    x = torch.randn(16, 6, generator=gen, dtype=torch.float64)
    y = torch.randint(0, 3, (16,), generator=gen)
    opt = thf.HessianFree(params, model_fn=mlp_apply,
                          loss_outer=cross_entropy_loss, cg_max_iter=20)
    losses = [opt.step((x, y)) for _ in range(4)]
    assert losses[-1] < opt.history["init_losses"][0]


@pytest.mark.parametrize("combined", ["precond_diag", "M", "mvp", "grad_vec"])
def test_precond_lowrank_validation_matches_jax(combined):
    params, x, y = _mlp_problem(6)
    t_opt = thf.HessianFree(params_from_jax(params, device="cpu"),
                            model_fn=_t_mlp, loss_outer=mse_loss)
    j_opt = jhf.HessianFree(jax.tree_util.tree_map(jnp.asarray, params),
                            model_fn=_j_mlp, loss_outer=_j_mse)
    t_batch = (torch.tensor(x), torch.tensor(y))
    j_batch = (jnp.asarray(x), jnp.asarray(y))
    t_sk = t_opt.get_nystrom_sketch(t_batch, rank=4)
    j_sk = j_opt.get_nystrom_sketch(j_batch, rank=4)
    t_arg = {"precond_diag": torch.ones(t_opt.ravel.dim, dtype=torch.float64),
             "M": lambda v: v, "mvp": lambda v: v,
             "grad_vec": torch.ones(t_opt.ravel.dim, dtype=torch.float64)}
    j_arg = {"precond_diag": jnp.ones(j_opt.ravel.dim), "M": lambda v: v,
             "mvp": lambda v: v, "grad_vec": jnp.ones(j_opt.ravel.dim)}
    with pytest.raises(ValueError) as t_err:
        t_opt.step(t_batch, precond_lowrank=t_sk,
                   **{combined: t_arg[combined]})
    with pytest.raises(ValueError) as j_err:
        j_opt.step(j_batch, precond_lowrank=j_sk,
                   **{combined: j_arg[combined]})
    assert str(t_err.value) == str(j_err.value)
    assert int(t_opt.state.step_count) == 0
