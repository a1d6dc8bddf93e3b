"""The plain references against the port at tiny sizes, in float64: each
family's forward and loss, the Gauss-Newton matvec, and the frozen plain
Hessian-free step against the port's ``hf_step`` and ``hf_acc_step``."""

from __future__ import annotations

import pytest
import torch

from hfbench import manifest
from hfbench.reference import hf
from hfbench.reference.problem import Problem
from hfbench.reference.tree import Flat, by_path

from .conftest import TINY_MODELS

LM = dict(TINY_MODELS["gpt2-small"], zipf_s=1.0)
CNN = dict(size=12, in_channels=3, kernels=[3] * 7 + [1, 1],
           channels=TINY_MODELS["allcnnc-cifar100"]["channels"],
           strides=[1, 1, 2, 1, 1, 2, 1, 1, 1],
           padding=["SAME"] * 6 + ["VALID", "SAME", "SAME"], l2=5e-4)
CASES = [("decoder_lm", LM, dict(seq_len=16)), ("allcnnc", CNN, {})]


def setup(family, model, traffic, rows=6, seed=3):
    fam = manifest.module(manifest.ROOT, "families", family)
    ref = manifest.module(manifest.ROOT, "reference", family)
    gen = torch.Generator().manual_seed(seed)
    params = fam.make_params(model, gen, "cpu", dtype=torch.float64)
    x, y = fam.make_rows(model, traffic, rows, gen, "cpu")
    if x.is_floating_point():
        x = x.double()
    return fam, ref, params, (x, y)


@pytest.mark.parametrize("family,model,traffic", CASES)
def test_forward_and_loss_match_the_port(family, model, traffic):
    fam, ref, params, (x, y) = setup(family, model, traffic)
    fns = fam.program_fns(model)
    out = fns["model_fn"](params, x)
    torch.testing.assert_close(ref.outputs(params, x, model), out,
                               rtol=1e-12, atol=1e-12)
    loss = fns["loss_outer"](out, y)
    if fns["loss_reg"] is not None:
        loss = loss + fns["loss_reg"](params)
    prob = Problem(ref, model, params, [(x, y)], [(x, y)])
    torch.testing.assert_close(
        prob.loss(prob.flat.flat(params)), loss, rtol=1e-12, atol=0)


@pytest.mark.parametrize("family,model,traffic", CASES)
def test_ggn_matvec_matches_the_port(family, model, traffic):
    from pytorchhessianfree_tpu_torch.ops.curvature import ggnvp

    fam, ref, params, (x, y) = setup(family, model, traffic)
    fns = fam.program_fns(model)
    prob = Problem(ref, model, params, [(x, y)], [(x, y)])
    v = torch.randn(prob.flat.flat(params).shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    mine = prob.ggn(prob.flat.flat(params))(v)
    port = ggnvp(lambda p: fns["model_fn"](p, x),
                 lambda o: fns["loss_outer"](o, y), params, prob.flat.tree(v))
    torch.testing.assert_close(mine, prob.flat.flat(port), rtol=1e-10,
                               atol=1e-13)


def _port_state(pkg, params, flat_of, damping, x0=None):
    from pytorchhessianfree_tpu_torch.utils.flatten import TrainableRavel

    ravel = TrainableRavel(params, pad_to_multiple=1024)
    state = pkg.optimizer.init_state(ravel, pkg.HFConfig(damping=damping))
    if x0 is not None:
        state = state._replace(x0=ravel.ravel(x0))
    return ravel, state


# the cells' CG: no stop on the residual, nor while the quadratic falls
HELD = dict(tol=0.0, martens_threshold=0.0)


@pytest.mark.parametrize("held", [False, True], ids=["martens", "held"])
@pytest.mark.parametrize("steps", [1, 2])
def test_plain_step_matches_hf_step(steps, held):
    import pytorchhessianfree_tpu_torch as pkg

    fam, ref, params, batch = setup("decoder_lm", LM, dict(seq_len=16))
    fns = pkg.optimizer.HFModelFns(**fam.program_fns(LM))
    fields = dict(damping=1.0, cg_max_iter=20)
    if held:
        fields["cg"] = HELD
    config = pkg.HFConfig(**dict(fields, cg=pkg.CGConfig(**HELD))
                          if held else fields)
    settings = hf.settings_of(fields)
    ravel, state = _port_state(pkg, params, None, 1.0)
    prob = Problem(ref, LM, params, [batch], [batch])
    flat = prob.flat
    w, x0, damping = flat.flat(params), torch.zeros_like(flat.flat(params)), 1.0
    for _ in range(steps):
        params, state, stats = pkg.hf_step(params, state, batch, fns=fns,
                                           config=config, ravel=ravel)
        prob = Problem(ref, LM, flat.tree(w), [batch], [batch])
        value, g = prob.value_and_grad(w)
        out = hf.step(w, x0, damping, prob.loss, g, value, prob.ggn(w),
                      settings)
        assert out["cg_iters"] == stats.num_cg_iters
        if held:
            assert out["cg_iters"] == 20
        # following its own choice, the step is the same and selects 0
        again = hf.step(w, x0, damping, prob.loss, g, value, prob.ggn(w),
                        settings, follow=(out["best_iter"], out["cg_iters"]))
        assert again["select"] == 0.0
        torch.testing.assert_close(again["w"], out["w"], rtol=0, atol=0)
        assert out["lr"] == pytest.approx(float(stats.lr), rel=1e-6)
        w, x0, damping = out["w"], out["x0"], out["damping"]
        assert damping == pytest.approx(float(state.damping), rel=1e-12)
        torch.testing.assert_close(flat.flat(params), w, rtol=1e-9,
                                   atol=1e-12)
        # a CG solve carries rounding across iterations: norm-wise
        gap = torch.linalg.vector_norm(ravel.ravel(flat.tree(x0)) - state.x0)
        assert gap <= 1e-6 * torch.linalg.vector_norm(state.x0)


def test_plain_preconditioned_step_matches_hf_acc_step():
    import pytorchhessianfree_tpu_torch as pkg

    fam, ref, params, (x, y) = setup("allcnnc", CNN, {}, rows=8)
    fns = pkg.optimizer.HFModelFns(**fam.program_fns(CNN))
    config = pkg.HFConfig(damping=1.0, cg_max_iter=15)
    ravel, state = _port_state(pkg, params, None, 1.0)
    chunks = [(x[:4], y[:4]), (x[4:], y[4:])]
    diag = pkg.diag_EF(fns.model_fn, fns.loss_outer, params, x[:4], y[:4],
                       "mean", ravel, loss_reg=fns.loss_reg)
    new, state, stats = pkg.hf_acc_step(
        params, state, fns=fns, config=config, ravel=ravel,
        loss_data=chunks, mvp_data=chunks[:1], precond_diag=diag,
        precond_exponent=0.75)
    prob = Problem(ref, CNN, params, chunks, chunks[:1])
    w = prob.flat.flat(params)
    value, g = prob.value_and_grad(w)
    d = prob.diag(w, x[:4], y[:4], block=3)
    torch.testing.assert_close(ravel.ravel(prob.flat.tree(d)), diag,
                               rtol=1e-10, atol=1e-14)
    out = hf.step(w, torch.zeros_like(w), 1.0, prob.loss, g, value,
                  prob.ggn(w), dict(cg_max_iter=15), diag=d)
    assert out["cg_iters"] == stats.num_cg_iters
    torch.testing.assert_close(prob.flat.flat(new), out["w"], rtol=1e-9,
                               atol=1e-12)
    assert out["damping"] == pytest.approx(float(state.damping), rel=1e-12)


def test_settings_follow_the_program_config_layout():
    fields = dict(damping=1.0, cg_max_iter=50, cg=HELD,
                  linesearch=dict(beta=0.5))
    assert hf.settings_of(fields) == dict(
        cg_max_iter=50, cg_tol=0.0, martens_threshold=0.0, ls_beta=0.5)
    with pytest.raises(KeyError):
        hf.settings_of(dict(cg=dict(store_dtype="bfloat16")))


def test_flat_round_trip_follows_the_paths():
    _, _, params, _ = setup("decoder_lm", LM, dict(seq_len=16))
    flat = Flat(params)
    back = by_path(flat.tree(flat.flat(params)))
    for path, leaf in by_path(params).items():
        assert torch.equal(back[path], leaf)
