"""The ``torch.nn.Module`` adapter (``pytorchhessianfree_tpu_torch.interop``):
an ``nn.Sequential`` MLP's HF steps and a narrow ``nn.Sequential``
All-CNN-C's loss, gradient and GGN matvec against the JAX package's
functional models in f64; buffers frozen within a step; a buffer-updating
forward refused; ``module_state_update``; dropout masks from the seed in
the batch, the linearized matvec equal to the one-shot one."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch import nn  # noqa: E402

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu.optimizer import (  # noqa: E402
    _build_matvec_and_grad as j_build,
)
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.interop import (  # noqa: E402
    module_fns,
    module_state_update,
    split_module_state,
)
from pytorchhessianfree_tpu_torch.models.resnet import batchnorm  # noqa: E402
from pytorchhessianfree_tpu_torch.optimizer import (  # noqa: E402
    _build_matvec_and_grad as t_build,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples_torch.example_utils import (  # noqa: E402
    allcnnc_sequential,
    load_hwio_convs,
)
from test_torch_optimizer import assert_vec_close  # noqa: E402

F64 = torch.float64


def _mlp_module(sizes=(7, 5, 5, 3)):
    layers = []
    for i in range(len(sizes) - 1):
        layers += [nn.Linear(sizes[i], sizes[i + 1]), nn.Tanh()]
    return nn.Sequential(*layers[:-1]).to(F64)


@torch.no_grad()
def _load_dense(module, jparams):
    """JAX ``{"layers": [{"w": [in, out], "b"}]}`` -> the module's
    ``nn.Linear`` layers in order."""
    linears = [m for m in module if isinstance(m, nn.Linear)]
    for m, layer in zip(linears, jparams["layers"]):
        m.weight.copy_(torch.tensor(np.asarray(layer["w"])).T)
        m.bias.copy_(torch.tensor(np.asarray(layer["b"])))
    return module


def test_module_mlp_steps_match_jax():
    """Weights from the JAX ``init_mlp``; ``module_fns`` + ``make_hf_step``
    against JAX ``make_hf_step`` with ``mlp_apply``: the same CG decisions
    and losses within rtol 1e-9 over two steps."""
    jparams = jm.init_mlp(jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((16, 7)), rng.standard_normal((16, 3))
    net = _load_dense(_mlp_module(), jparams)
    params, _ = split_module_state(net)

    cfg = dict(damping=0.5, cg_max_iter=20)
    jr = jhf.TrainableRavel(jparams)
    j_step = jhf.make_hf_step(
        jhf.HFModelFns(model_fn=jm.mlp_apply, loss_outer=jm.mse_loss),
        jhf.HFConfig(**cfg), jr)
    tr = thf.TrainableRavel(params)
    t_step = thf.make_hf_step(module_fns(net, tm.mse_loss),
                              thf.HFConfig(**cfg), tr)
    js, ts = jhf.init_state(jr, jhf.HFConfig(**cfg)), thf.init_state(
        tr, thf.HFConfig(**cfg))
    jb = (jnp.asarray(x), jnp.asarray(y))
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    for i in range(2):
        jparams, js, jst = j_step(jparams, js, jb)
        params, ts, tst = t_step(params, ts, tb)
        assert (tst.num_cg_iters, tst.cg_reason, tst.best_cg_iter) == (
            int(jst.num_cg_iters), int(jst.cg_reason), int(jst.best_cg_iter))
        for name in ("init_loss", "final_loss", "lr", "new_damping"):
            np.testing.assert_allclose(float(getattr(tst, name)),
                                       float(getattr(jst, name)), rtol=1e-9)
    # the parameters, in the JAX layout
    back = {"layers": [{"w": params[f"{i}.weight"].T, "b": params[f"{i}.bias"]}
                       for i in (0, 2, 4)]}
    assert_vec_close(thf.TrainableRavel(back).ravel(back).numpy(),
                     np.asarray(jr.ravel(jparams)), 1e-9)


def _allcnnc_pair():
    jparams = jm.init_allcnnc(jax.random.PRNGKey(0), width_scale=0.125,
                              dtype=jnp.float64)
    tparams = jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)), jparams)
    net = load_hwio_convs(allcnnc_sequential(width_scale=0.125).to(F64),
                          tparams)
    names = [n for n, m in net.named_modules() if isinstance(m, nn.Conv2d)]
    return jparams, net, names


def _to_module(tree, names):
    out = {}
    for name, layer in zip(names, tree["convs"]):
        out[f"{name}.weight"] = torch.as_tensor(
            np.asarray(layer["w"])).permute(3, 2, 0, 1).contiguous()
        out[f"{name}.bias"] = torch.as_tensor(np.asarray(layer["b"]))
    return out


def _to_jax(params, names):
    return {"convs": [
        {"w": jnp.asarray(params[f"{n}.weight"].permute(2, 3, 1, 0).numpy()),
         "b": jnp.asarray(params[f"{n}.bias"].numpy())} for n in names]}


def _l2_module(p, coeff=5e-4):
    return 0.5 * coeff * sum(torch.sum(v**2) for k, v in p.items()
                             if k.endswith("weight"))


def test_narrow_allcnnc_module_matches_jax_allcnnc_apply():
    """``nn.Sequential`` All-CNN-C at an eighth of the width (NCHW, a
    ``ZeroPad2d((0, 1, 0, 1))`` before each stride-2 conv) against the JAX
    ``allcnnc_apply`` (NHWC, "SAME"): loss with L2, gradient and GGN matvec
    within rtol 1e-9."""
    jparams, net, names = _allcnnc_pair()
    params, _ = split_module_state(net)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3))
    y = rng.integers(0, 100, 4)

    jr = jhf.TrainableRavel(jparams)
    jfns = jhf.HFModelFns(model_fn=jm.allcnnc_apply,
                          loss_outer=jm.cross_entropy_loss,
                          loss_reg=jm.l2_regularizer)
    j_loss, j_grad, j_mvp = j_build(jfns, jhf.HFConfig(), jr, jparams,
                                    (jnp.asarray(x), jnp.asarray(y)))
    tr = thf.TrainableRavel(params)
    tfns = module_fns(net, tm.cross_entropy_loss, loss_reg=_l2_module)
    batch = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
             torch.from_numpy(y))
    t_loss, t_grad, t_mvp = t_build(tfns, thf.HFConfig(), tr, params, batch)

    def jax_vec(t_vec):
        return np.asarray(jr.ravel(_to_jax(tr.unravel(t_vec), names)))

    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-9)
    assert_vec_close(jax_vec(t_grad), np.asarray(j_grad), 1e-9)
    v = rng.standard_normal(jr.dim)
    t_v = tr.ravel(_to_module(jr.unravel(jnp.asarray(v)), names))
    assert_vec_close(jax_vec(t_mvp(t_v)), np.asarray(j_mvp(jnp.asarray(v))),
                     1e-9)


def _bn_net():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(7, 8), nn.BatchNorm1d(8), nn.Tanh(),
                         nn.Linear(8, 3)).to(F64)


def _xy(n=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, 7), generator=g, dtype=F64),
            torch.randn((n, 3), generator=g, dtype=F64))


def test_buffers_are_frozen_within_a_step():
    """Running-average BatchNorm: every evaluation of a step reads the same
    buffers; neither the adapter's copy nor the module's own changes."""
    net = _bn_net()
    x, y = _xy()
    params, bufs = split_module_state(net)
    bufs = module_state_update(net, params, bufs, x)  # non-trivial stats
    net.eval()
    kept = {k: v.clone() for k, v in bufs.items()}
    own = {k: v.clone() for k, v in net.state_dict().items()}
    fns = module_fns(net, tm.mse_loss, buffers=bufs)
    np.testing.assert_array_equal(fns.model_fn(params, x).detach().numpy(),
                                  fns.model_fn(params, x).detach().numpy())
    opt = thf.HessianFree(params, model_fn=fns.model_fn,
                          loss_outer=fns.loss_outer, damping=0.5,
                          cg_max_iter=20)
    for _ in range(2):
        opt.step((x, y))
    assert opt.history["final_losses"][-1] < opt.history["init_losses"][0]
    for k in kept:
        assert torch.equal(bufs[k], kept[k]), k
        assert torch.equal(net.state_dict()[k], own[k]), k
    assert not net.training


def test_training_mode_batchnorm_with_running_stats_raises():
    net = _bn_net().train()
    params, bufs = split_module_state(net)
    own = {k: v.clone() for k, v in net.state_dict().items()}
    fns = module_fns(net, tm.mse_loss)
    with pytest.raises(RuntimeError, match="track_running_stats"):
        fns.model_fn(params, _xy()[0])
    for k, v in own.items():
        assert torch.equal(net.state_dict()[k], v)


def test_a_forward_that_writes_a_buffer_raises():
    class Counting(nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(7, 3)
            self.register_buffer("calls", torch.zeros((), dtype=torch.int64))

        def forward(self, x):
            self.calls += 1
            return self.lin(x)

    net = Counting().to(F64)
    params, _ = split_module_state(net)
    with pytest.raises(RuntimeError, match="in place"):
        module_fns(net).model_fn(params, _xy()[0])
    assert int(net.calls) == 0


def test_batch_statistics_batchnorm_is_the_functional_batchnorm():
    """``track_running_stats=False`` is allowed in training mode and
    normalizes as the port's ``resnet18_apply`` does."""
    net = nn.Sequential(nn.BatchNorm2d(4, track_running_stats=False)).to(F64)
    with torch.no_grad():
        net[0].weight.uniform_(0.5, 1.5)
        net[0].bias.uniform_(-0.5, 0.5)
    params, bufs = split_module_state(net)
    assert bufs == {}
    x = torch.randn((3, 4, 5, 5), generator=torch.Generator().manual_seed(2),
                    dtype=F64)
    out = module_fns(net).model_fn(params, x)
    ref = batchnorm(x, params["0.weight"], params["0.bias"])
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_module_state_update_refreshes_stats_and_leaves_the_module():
    net = _bn_net()
    net.eval()
    net[0].train()  # mixed modes, restored exactly
    modes = [m.training for m in net.modules()]
    own = {k: v.clone() for k, v in net.state_dict().items()}
    params, bufs = split_module_state(net)
    x, _ = _xy()
    new = module_state_update(net, params, bufs, x)
    h = x @ params["0.weight"].T + params["0.bias"]
    np.testing.assert_allclose(new["1.running_mean"].numpy(),
                               (0.9 * bufs["1.running_mean"]
                                + 0.1 * h.mean(0)).numpy(), rtol=1e-12)
    assert int(new["1.num_batches_tracked"]) == 1
    assert int(bufs["1.num_batches_tracked"]) == 0
    assert [m.training for m in net.modules()] == modes
    for k, v in own.items():
        assert torch.equal(net.state_dict()[k], v), k


def _dropout_net(rate=0.3):
    torch.manual_seed(1)
    return nn.Sequential(
        nn.Linear(7, 16), nn.Tanh(), nn.Dropout(rate),
        nn.Linear(16, 16), nn.Tanh(), nn.Dropout(rate),
        nn.Linear(16, 3),
    ).to(F64).train()


def test_dropout_masks_come_from_the_seed_in_the_batch():
    """One seed, one set of masks on every evaluation -- those of the
    port's ``mlp_dropout_apply``; another seed, other masks; an active
    dropout without the seed raises."""
    net = _dropout_net()
    params, _ = split_module_state(net)
    x, _ = _xy()
    fns = module_fns(net, rng_in_batch=True)
    a, b = fns.model_fn(params, (x, 7)), fns.model_fn(params, (x, 7))
    assert torch.equal(a, b)
    assert not torch.equal(a, fns.model_fn(params, (x, 8)))
    functional = {"layers": [{"w": params[f"{i}.weight"].T,
                              "b": params[f"{i}.bias"]} for i in (0, 3, 6)]}
    np.testing.assert_allclose(
        a.detach().numpy(),
        tm.mlp_dropout_apply(functional, (x, 7), rate=0.3).detach().numpy(),
        rtol=1e-12)
    with pytest.raises(RuntimeError, match="rng_in_batch"):
        module_fns(net).model_fn(params, x)
    net.eval()  # inactive dropout needs no seed
    np.testing.assert_array_equal(
        module_fns(net).model_fn(params, x).detach().numpy(),
        tm.mlp_apply(functional, x).detach().numpy())


@pytest.mark.parametrize("buffers_in_batch", [False, True])
def test_seeded_dropout_linearized_matvec_equals_one_shot(buffers_in_batch):
    """``torch.func.linearize`` replays its trace for every matvec; the
    masks are constants of that trace, so the replay equals the one-shot
    matvec that ``HFConfig(remat=True)`` builds.  With the buffers in the
    batch too (a running-average BatchNorm), and the step's determinism
    self-test all true."""
    net = _dropout_net()
    net.insert(1, nn.BatchNorm1d(16).to(F64).eval())
    params, bufs = split_module_state(net)
    x, y = _xy()
    bufs = {k: v + 0.1 if v.is_floating_point() else v
            for k, v in bufs.items()}
    if buffers_in_batch:
        fns = module_fns(net, tm.mse_loss, buffers_in_batch=True,
                         rng_in_batch=True)
        batch = ((x, 3, bufs), y)
    else:
        fns = module_fns(net, tm.mse_loss, buffers=bufs, rng_in_batch=True)
        batch = ((x, 3), y)
    ravel = thf.TrainableRavel(params)
    v = torch.randn(ravel.dim, generator=torch.Generator().manual_seed(4),
                    dtype=F64)
    lin = t_build(fns, thf.HFConfig(), ravel, params, batch)[2](v)
    one = t_build(fns, thf.HFConfig(remat=True), ravel, params, batch)[2](v)
    assert_vec_close(lin.numpy(), one.numpy(), 1e-12)
    res = thf.check_deterministic(fns, thf.HFConfig(), ravel, params, batch)
    assert all(res.values()), res
