"""Preconditioning parity: the port's empirical-Fisher diagonal and the
preconditioned steps against the JAX package, in f64.

``diag_EF`` (``torch.func.vmap``) and ``diag_EF_scan`` (a loop over the
samples) are held against JAX's ``diag_EF`` at rtol 1e-10 on an MLP (with
and without a frozen first layer), a narrow All-CNN-C and a narrow
ResNet-18 (whose batch-statistics BN sees one sample at a time), each with
and without a regularizer.  Preconditioned steps must take the same CG
iterations, reasons, best iterates and dampings as JAX's, with parameters
within rtol 1e-8.
"""

import functools

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
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
)
from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

EXPONENT = 0.6  # not the default 0.75: a hard-coded exponent fails


def _j_l2(p):
    return 5e-3 * sum(jnp.sum(q**2) for q in jax.tree_util.tree_leaves(p))


def _t_l2(p):
    return 5e-3 * sum(torch.sum(q**2) for q in tree_flatten(p)[0])


def _models():
    """name -> (JAX init, JAX apply, port apply, loss pair, regs, input
    shape, classes or output width, trainable-mask function)."""
    mlp = (lambda k: jm.init_mlp(k, dtype=jnp.float64), jm.mlp_apply,
           tm.mlp_apply, (jm.mse_loss, tm.mse_loss), (_j_l2, _t_l2), (7,), -3)
    return {
        "mlp": mlp + (None,),
        "mlp_frozen": mlp + (jm.freeze_first_layer,),
        "allcnnc": (
            lambda k: jm.init_allcnnc(k, dtype=jnp.float64, width_scale=1 / 8),
            jm.allcnnc_apply, tm.allcnnc_apply,
            (jm.cross_entropy_loss, tm.cross_entropy_loss),
            (jm.l2_regularizer, tm.l2_regularizer), (32, 32, 3), 100, None,
        ),
        "resnet18": (
            lambda k: jm.init_resnet18(k, dtype=jnp.float64,
                                       width_scale=1 / 16),
            jm.resnet18_apply, tm.resnet18_apply,
            (jm.cross_entropy_loss, tm.cross_entropy_loss),
            (_j_l2, _t_l2), (28, 28, 1), 10, None,
        ),
    }


@functools.lru_cache(maxsize=None)
def _problem(name):
    """Both packages' params, ravels and batch, and JAX's diagonals without
    and with the regularizer (one jitted program for both)."""
    (j_init, j_apply, t_apply, (j_loss, t_loss), (j_reg, t_reg), shape,
     out, mask_fn) = _models()[name]
    jparams = jax.jit(j_init)(jax.random.PRNGKey(3))
    trainable = None if mask_fn is None else mask_fn(jparams)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5,) + shape)
    y = (rng.standard_normal((5, -out)) if out < 0
         else rng.integers(0, out, 5))
    jr = jhf.TrainableRavel(jparams, trainable, pad_to_multiple=256)

    @jax.jit
    def j_diags(p, x, y):
        return [
            jhf.diag_EF(j_apply, j_loss, p, x, y, "mean", jr, loss_reg=reg)
            for reg in (None, j_reg)
        ]

    j_out = [np.asarray(d) for d in j_diags(jparams, x, y)]
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    tr = thf.TrainableRavel(tparams, trainable, pad_to_multiple=256)
    t_fns = (t_apply, t_loss, t_reg)
    return tparams, tr, torch.tensor(x), torch.tensor(y), t_fns, j_out


@pytest.mark.parametrize("fn", ["diag_EF", "diag_EF_scan"])
@pytest.mark.parametrize("reg", [False, True])
@pytest.mark.parametrize("name", ["mlp", "mlp_frozen", "allcnnc", "resnet18"])
def test_diag_EF_matches_jax(name, reg, fn):
    tparams, tr, x, y, (apply, loss, t_reg), j_diags = _problem(name)
    diag = getattr(thf, fn)(apply, loss, tparams, x, y, "mean", tr,
                            loss_reg=t_reg if reg else None)
    assert diag.shape == (tr.dim,) and tr.dim % 256 == 0
    np.testing.assert_allclose(diag.numpy(), j_diags[reg], rtol=1e-10,
                               atol=1e-300)
    if name == "mlp_frozen":
        # the frozen first layer is not in the flat space at all
        assert tr.unpadded_dim == sum(
            t.numel() for t in tree_flatten(tparams["layers"][1:])[0])


@pytest.mark.parametrize("fn", ["diag_EF", "diag_EF_scan"])
def test_diag_EF_sum_is_n_times_mean_and_bad_reduction_raises(fn):
    tparams, tr, x, y, (apply, loss, _), _ = _problem("mlp")
    f = getattr(thf, fn)
    mean = f(apply, loss, tparams, x, y, "mean", tr)
    total = f(apply, loss, tparams, x, y, "sum", tr)
    torch.testing.assert_close(total, x.shape[0] * mean, rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="not supported"):
        f(apply, loss, tparams, x, y, "median", tr)


def test_preconditioner_closure_and_ema_match_jax():
    tparams, tr, x, y, (apply, loss, _), _ = _problem("mlp")
    M, diag = thf.diag_EF_preconditioner(apply, loss, tparams, x, y, "mean",
                                         damping=0.5, exponent=EXPONENT,
                                         ravel=tr, use_scan=True)
    jM = jhf.diag_to_preconditioner(jnp.asarray(diag.numpy()), 0.5, EXPONENT)
    v = np.random.default_rng(0).standard_normal(tr.dim)
    np.testing.assert_allclose(M(torch.tensor(v)).numpy(),
                               np.asarray(jM(jnp.asarray(v))), rtol=1e-14)
    # default exponent and ravel, as JAX's
    M0, d0 = thf.diag_EF_preconditioner(apply, loss, tparams, x, y, "sum",
                                        damping=2.0)
    torch.testing.assert_close(M0(torch.ones_like(d0)), (d0 + 2.0) ** -0.75)

    t_ema, j_ema = thf.EMADiag(0.8), jhf.EMADiag(0.8)
    rng = np.random.default_rng(1)
    for _ in range(3):
        d = rng.uniform(size=4)
        np.testing.assert_allclose(
            t_ema.update(torch.tensor(d)).numpy(),
            np.asarray(j_ema.update(jnp.asarray(d))), rtol=1e-15)
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError, match="Invalid decay"):
            thf.EMADiag(bad)


def _wrappers(name, seed, **cfg):
    """The port's and JAX's ``HessianFree`` on the same weights."""
    (j_init, j_apply, t_apply, (j_loss, t_loss), (j_reg, t_reg), _, _,
     _) = _models()[name]
    jparams = jax.jit(j_init)(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    reg = name == "allcnnc"
    j_opt = jhf.HessianFree(jparams, model_fn=j_apply, loss_outer=j_loss,
                            loss_reg=j_reg if reg else None, **cfg)
    t_opt = thf.HessianFree(tparams, model_fn=t_apply, loss_outer=t_loss,
                            loss_reg=t_reg if reg else None, **cfg)
    return t_opt, j_opt


def _mlp_batch(seed, n=16):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 7)), rng.standard_normal((n, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_three_mlp_steps_with_in_step_diag_ef_match_jax(seed):
    t_opt, j_opt = _wrappers("mlp", seed, damping=1.0, cg_max_iter=20,
                             precond="diag_ef", precond_exponent=EXPONENT)
    x, y = _mlp_batch(seed)
    for _ in range(3):
        j_opt.step((jnp.asarray(x), jnp.asarray(y)))
        t_opt.step((torch.tensor(x), torch.tensor(y)))
    assert_same_step(t_opt, j_opt, 1e-8)


def test_three_mlp_steps_with_precond_diag_match_jax():
    t_opt, j_opt = _wrappers("mlp", 2, damping=1.0, cg_max_iter=20,
                             precond_exponent=EXPONENT)
    t_ema, j_ema = thf.EMADiag(0.9), jhf.EMADiag(0.9)
    for i in range(3):
        x, y = _mlp_batch(10 + i)
        jd = j_opt.get_preconditioner(jnp.asarray(x), jnp.asarray(y), "mean")
        td = t_opt.get_preconditioner(torch.tensor(x), torch.tensor(y),
                                      "mean", use_scan=i == 1)
        assert_vec_close(td.numpy(), np.asarray(jd), 1e-12)
        j_opt.step((jnp.asarray(x), jnp.asarray(y)),
                   precond_diag=j_ema.update(jd))
        t_opt.step((torch.tensor(x), torch.tensor(y)),
                   precond_diag=t_ema.update(td))
    assert_same_step(t_opt, j_opt, 1e-8)


def test_two_allcnnc_steps_with_in_step_diag_ef_match_jax():
    # CG iterates on this system grow last-bit differences ~25x per
    # iteration past the sixth (the same CG fed both packages' matvecs
    # differs as much as the two CGs do): 6 iterations keep them ~1e-11
    t_opt, j_opt = _wrappers("allcnnc", 4, damping=1.0, cg_max_iter=6,
                             precond="diag_ef", precond_exponent=EXPONENT)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 32, 32, 3))
    y = rng.integers(0, 100, 6)
    for _ in range(2):
        j_opt.step((jnp.asarray(x), jnp.asarray(y)))
        t_opt.step((torch.tensor(x), torch.tensor(y)))
    assert_same_step(t_opt, j_opt, 1e-8)


def test_in_step_diag_ef_needs_the_split_form():
    params = {"x": torch.ones(3, dtype=torch.float64)}
    fns = thf.HFModelFns(loss_fn=lambda p, b: torch.sum(p["x"] ** 2))
    cfg = thf.HFConfig(curvature_opt="hessian", precond="diag_ef",
                       cg_max_iter=5)
    ravel = thf.TrainableRavel(params)
    with pytest.raises(ValueError, match="split model form"):
        thf.hf_step(params, thf.init_state(ravel, cfg), None, fns=fns,
                    config=cfg, ravel=ravel)
