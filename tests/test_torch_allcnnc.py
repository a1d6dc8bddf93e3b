"""Model parity: All-CNN-C, the rest of the MLP module and the analytic
targets of the port against the JAX package, in f64, with weights carried
over by ``params_from_jax``; and 2 narrow All-CNN-C ``acc_step``s with the
empirical-Fisher diagonal against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu.models.resnet import conv as j_conv  # noqa: E402
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models.resnet import conv  # noqa: E402
from pytorchhessianfree_tpu_torch.ops.curvature import ggnvp  # noqa: E402
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad,
)
from pytorchhessianfree_tpu_torch.utils.flatten import (  # noqa: E402
    tree_flatten,
)
from test_torch_optimizer import assert_same_step, assert_vec_close  # noqa: E402

FULL_PARAMS = 1_387_108
FULL_DIM = 1_387_520  # padded to a multiple of 1024


def _carry(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


@functools.lru_cache(maxsize=None)
def _narrow_allcnnc(seed=0):
    jparams = jax.jit(lambda k: jm.init_allcnnc(
        k, dtype=jnp.float64, width_scale=1 / 8))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 32, 32, 3))
    y = rng.integers(0, 100, 4)
    return jparams, x, y


def test_full_width_allcnnc_counts_and_shapes():
    gen = torch.Generator().manual_seed(0)
    params = tm.init_allcnnc(gen)
    assert sum(t.numel() for t in tree_flatten(params)[0]) == FULL_PARAMS
    assert thf.TrainableRavel(params, pad_to_multiple=1024).dim == FULL_DIM
    jparams = jax.eval_shape(jm.init_allcnnc, jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in tree_flatten(params)[0]] == [
        t.shape for t in jax.tree_util.tree_leaves(jparams)]
    # He-normal kernels, zero biases, as JAX's initializer
    w0 = params["convs"][0]["w"]
    assert abs(float(w0.std()) - (2 / 27) ** 0.5) < 0.05
    assert all(float(c["b"].abs().sum()) == 0 for c in params["convs"])


def test_allcnnc_forward_loss_and_gradient_match_jax():
    jparams, x, y = _narrow_allcnnc()
    tparams = _carry(jparams)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    out = tm.allcnnc_apply(tparams, tx)
    assert out.shape == (4, 100)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax.jit(jm.allcnnc_apply)(jparams,
                                                                    jx)),
                               rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(float(tm.l2_regularizer(tparams, 1e-3)),
                               float(jm.l2_regularizer(jparams, 1e-3)),
                               rtol=1e-13)

    def j_obj(p):
        return jm.cross_entropy_loss(jm.allcnnc_apply(p, jx), jnp.asarray(
            y)) + jm.l2_regularizer(p)

    def t_obj(p):
        return tm.cross_entropy_loss(tm.allcnnc_apply(p, tx), torch.tensor(
            y)) + tm.l2_regularizer(p)

    jr, tr = jhf.TrainableRavel(jparams), thf.TrainableRavel(tparams)
    jv, jg = jax.jit(jax.value_and_grad(j_obj))(jparams)
    tg, tv = torch.func.grad_and_value(t_obj)(tparams)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-12)
    assert_vec_close(tr.ravel(tg).numpy(), np.asarray(jr.ravel(jg)), 1e-10)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_padding_matches_jax(padding, stride):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal((2, 9, 8, 3))
    w = rng.standard_normal((3, 3, 3, 4))
    ref = j_conv(jnp.asarray(x), jnp.asarray(w), stride=stride,
                 padding=padding)
    out = conv(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w), stride,
               padding).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="padding"):
        conv(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(w), stride,
             "FULL")


@pytest.mark.parametrize("name", ["mse_loss_sum", "cross_entropy_loss_sum",
                                  "mse_per_sample",
                                  "cross_entropy_per_sample"])
def test_mlp_losses_match_jax(name):
    rng = np.random.default_rng(0)
    out = rng.standard_normal((6, 5))
    if name.startswith("mse"):
        targets = rng.standard_normal((6, 5))
    else:
        targets = rng.integers(0, 5, 6)
    got = getattr(tm, name)(torch.tensor(out), torch.tensor(targets))
    ref = getattr(jm, name)(jnp.asarray(out), jnp.asarray(targets))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13)


def test_freeze_first_layer_and_ravel_of_carried_trees_match_jax():
    jparams = jm.init_mlp(jax.random.PRNGKey(0), (7, 5, 5, 3),
                          dtype=jnp.float64)
    tparams = _carry(jparams)
    tmask = tm.freeze_first_layer(tparams)
    jmask = jm.freeze_first_layer(jparams)
    assert tree_flatten(tmask)[0] == jax.tree_util.tree_leaves(jmask)
    assert tree_flatten(tmask)[0][:2] == [False, False]
    cases = [(jparams, tparams, None, None, 64), (jparams, tparams, jmask,
                                                  tmask, None)]
    ja, _, _ = _narrow_allcnnc()
    cases.append((ja, _carry(ja), None, None, 1024))
    for jp, tp, jmk, tmk, pad in cases:
        jr = jhf.TrainableRavel(jp, jmk, pad_to_multiple=pad)
        tr = thf.TrainableRavel(tp, tmk, pad_to_multiple=pad)
        assert tr.dim == jr.dim
        np.testing.assert_array_equal(tr.ravel(tp).numpy(),
                                      np.asarray(jr.ravel(jp)))


def test_dropout_mlp_masks_are_a_function_of_the_seed():
    jparams = jm.init_mlp(jax.random.PRNGKey(1), (7, 16, 16, 3),
                          dtype=jnp.float64)
    tparams = _carry(jparams)
    x = np.random.default_rng(1).standard_normal((32, 7))
    tx = torch.tensor(x)
    a = tm.mlp_dropout_apply(tparams, (tx, 5), rate=0.3)
    assert torch.equal(a, tm.mlp_dropout_apply(tparams, (tx, 5), rate=0.3))
    assert not torch.equal(a, tm.mlp_dropout_apply(tparams, (tx, 6),
                                                   rate=0.3))
    # at rate 0 the model is JAX's
    np.testing.assert_allclose(
        tm.mlp_dropout_apply(tparams, (tx, 5), rate=0.0).numpy(),
        np.asarray(jm.mlp_dropout_apply(
            jparams, (jnp.asarray(x), jax.random.PRNGKey(5)), rate=0.0)),
        rtol=1e-13)
    # about `rate` of the hidden units are dropped
    h = torch.tanh(tx @ tparams["layers"][0]["w"] + tparams["layers"][0]["b"])
    mask = tm.mlp._keep_mask(h.shape, 5, 0, 0.7, h.device)
    assert 0.6 < float(mask.double().mean()) < 0.8


def test_dropout_mlp_trains_with_a_seed_per_step():
    """The seed rides in the batch: gradient, CG matvecs and trial forwards
    of one step share its masks, and HF trains the stochastic model; the
    same model with the generator fixed outside the batch is flagged."""
    gen = torch.Generator().manual_seed(0)
    params = tm.init_mlp(gen, (7, 16, 16, 3), dtype=torch.float64)
    x = torch.randn(32, 7, generator=gen, dtype=torch.float64)
    y = torch.tanh(x @ torch.randn(7, 3, generator=gen, dtype=torch.float64))
    model = functools.partial(tm.mlp_dropout_apply, rate=0.1)
    opt = thf.HessianFree(params, model_fn=model, loss_outer=tm.mse_loss,
                          damping=1.0, cg_max_iter=25, pad_to_multiple=None)
    assert all(opt.test_deterministic(((x, 3), y)).values())
    # the masks are constants of the linearized tangent graph: its matvec
    # equals the one-shot jvp/vjp matvec on the same seed
    _, _, mvp = _build_matvec_and_grad(opt.fns, opt.config, opt.ravel,
                                       opt.params, ((x, 3), y))
    v = torch.randn(opt.ravel.dim, generator=gen, dtype=torch.float64)
    one_shot = ggnvp(lambda p: model(p, (x, 3)), lambda o: tm.mse_loss(o, y),
                     opt.params, opt.ravel.unravel(v))
    torch.testing.assert_close(mvp(v), opt.ravel.ravel(one_shot), rtol=1e-12,
                               atol=1e-14)
    losses = [opt.step(((x, 42 + i), y)) for i in range(8)]
    assert losses[-1] < 0.5 * opt.history["init_losses"][0]

    def factory(generator):
        seed = int(torch.randint(2**31, (), generator=generator))
        return thf.HFModelFns(
            model_fn=lambda p, inp: tm.mlp_dropout_apply(p, (inp, seed)),
            loss_outer=tm.mse_loss)

    res = thf.check_deterministic(
        factory(torch.Generator().manual_seed(1)), thf.HFConfig(),
        opt.ravel, opt.params, (x, y), fns_factory=factory)
    assert res["rng_invariant"] is False and res["forward_deterministic"]


def test_rosenbrock_steps_match_jax_and_converge():
    jp, jfns = jm.rosenbrock_problem(dtype=jnp.float64)
    tp, tfns = tm.rosenbrock_problem(dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(float(tm.rosenbrock(tp["x"])),
                               float(jm.rosenbrock(jp["x"])), rtol=1e-15)
    kw = dict(curvature_opt="hessian", damping=0.5, cg_max_iter=50)
    j_o = jhf.HessianFree(jp, loss_fn=jfns.loss_fn, **kw)
    t_o = thf.HessianFree(tp, loss_fn=tfns.loss_fn, **kw)
    for _ in range(3):
        j_o.step(None)
        t_o.step(None)
    assert_same_step(t_o, j_o, 1e-10)
    for _ in range(17):
        t_o.step(None)
    np.testing.assert_allclose(t_o.params["x"].numpy(), [1.0, 1.0],
                               atol=1e-4)


def test_quadratic_problem_takes_one_newton_step():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((5, 5))
    A, b = q @ q.T + np.eye(5), rng.standard_normal(5)
    x0 = rng.standard_normal(5)
    params, fns = tm.quadratic_problem(torch.tensor(A), torch.tensor(b), 0.3,
                                       torch.tensor(x0))
    jparams, jfns = jm.quadratic_problem(jnp.asarray(A), jnp.asarray(b), 0.3,
                                         jnp.asarray(x0))
    np.testing.assert_allclose(float(fns.loss_fn(params, None)),
                               float(jfns.loss_fn(jparams, None)),
                               rtol=1e-14)
    cfg = thf.HFConfig(curvature_opt="hessian", lr=1.0, use_linesearch=False,
                       damping=0.0, adapt_damping=False,
                       use_cg_backtracking=False)
    ravel = thf.TrainableRavel(params)
    new, _, _ = thf.make_hf_step(fns, cfg, ravel)(
        params, thf.init_state(ravel, cfg), None)
    np.testing.assert_allclose(new["x"].numpy(), np.linalg.solve(A, -b),
                               atol=1e-8)
    assert torch.equal(params["x"], torch.tensor(x0))  # inputs untouched


def test_two_allcnnc_acc_steps_with_precond_diag_match_jax():
    jparams, _, _ = _narrow_allcnnc(1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 32, 32, 3))
    y = rng.integers(0, 100, 8)
    # 6 CG iterations: see test_torch_precond.py on how later iterates
    # grow last-bit differences on this system
    kw = dict(damping=1.0, cg_max_iter=6, precond_exponent=0.6)
    j_o = jhf.HessianFree(jparams, model_fn=jm.allcnnc_apply,
                          loss_outer=jm.cross_entropy_loss,
                          loss_reg=jm.l2_regularizer, **kw)
    t_o = thf.HessianFree(_carry(jparams), model_fn=tm.allcnnc_apply,
                          loss_outer=tm.cross_entropy_loss,
                          loss_reg=tm.l2_regularizer, **kw)
    j_data = [(jnp.asarray(x[a:a + 4]), jnp.asarray(y[a:a + 4]))
              for a in (0, 4)]
    t_data = [(torch.tensor(x[a:a + 4]), torch.tensor(y[a:a + 4]))
              for a in (0, 4)]
    for _ in range(2):
        jd = j_o.get_preconditioner(jnp.asarray(x), jnp.asarray(y), "mean")
        td = t_o.get_preconditioner(torch.tensor(x), torch.tensor(y), "mean")
        assert_vec_close(td.numpy(), np.asarray(jd), 1e-10)
        j_o.acc_step(j_data, precond_diag=jd)
        t_o.acc_step(t_data, precond_diag=td)
    assert_same_step(t_o, j_o, 1e-8)
