"""Checkpoint / resume: the port's counterparts of
``tests/test_checkpoint.py`` (round trips that continue bitwise, the torn-
save warning, template checks, the npz path rule), ``HessianFree.save`` /
``load`` with both backends, and npz files carried between the packages:
a JAX checkpoint restored by the port continues the JAX run step for
step."""

import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu import checkpoint as jck  # noqa: E402
from pytorchhessianfree_tpu import models as jm  # noqa: E402
from pytorchhessianfree_tpu_torch import checkpoint as tck  # noqa: E402
from pytorchhessianfree_tpu_torch import models as tm  # noqa: E402
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.utils.flatten import tree_flatten  # noqa: E402
from test_torch_optimizer import assert_same_step  # noqa: E402

BACKENDS = ["torch", "npz"]


def _setup():
    jparams = jm.init_mlp(jax.random.PRNGKey(0), dtype=jnp.float64)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    fns = thf.HFModelFns(model_fn=tm.mlp_apply, loss_outer=tm.mse_loss)
    config = thf.HFConfig(damping=0.5, cg_max_iter=30)
    ravel = thf.TrainableRavel(params)
    step = thf.make_hf_step(fns, config, ravel)
    rng = np.random.default_rng(0)
    batch = (torch.tensor(rng.standard_normal((16, 7))),
             torch.tensor(rng.standard_normal((16, 3))))
    return params, config, ravel, step, batch


def _save_restore(backend, path, params, state, history=None):
    if backend == "npz":
        tck.save_npz(path, params, state, history)
        return tck.restore_npz(path, params)
    tck.save(path, params, state, history)
    return tck.restore(path)


def _assert_trees_equal(a, b):
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("backend", BACKENDS)
def test_checkpoint_roundtrip_continues_identically(backend, tmp_path):
    params, config, ravel, step, batch = _setup()
    state = thf.init_state(ravel, config)
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    r_params, r_state, r_hist = _save_restore(
        backend, str(tmp_path / "ckpt"), params, state,
        {"init_losses": [1.0, 0.5]})
    assert r_hist["init_losses"] == [1.0, 0.5]
    assert int(r_state.step_count) == 2 and r_state.step_count.dtype == (
        torch.int64)
    assert torch.equal(r_state.x0, state.x0)
    assert torch.equal(r_state.damping, state.damping)
    p1, s1, st1 = step(params, state, batch)
    p2, s2, st2 = step(r_params, r_state, batch)
    _assert_trees_equal(p1, p2)
    assert float(st1.final_loss) == float(st2.final_loss)
    assert torch.equal(s1.x0, s2.x0)


def test_restore_warns_on_missing_history(tmp_path):
    params, config, ravel, _, _ = _setup()
    path = str(tmp_path / "ckpt")
    tck.save(path, params, thf.init_state(ravel, config),
             {"init_losses": [1.0]})
    assert sorted(os.listdir(path)) == ["history.json", "tree.pt"]  # no .tmp
    os.remove(os.path.join(path, "history.json"))  # a torn save
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        _, _, hist = tck.restore(path)
    assert hist == {}
    assert any("interrupted save" in str(x.message) for x in w)


def test_npz_leaf_count_mismatch(tmp_path):
    params, config, ravel, _, _ = _setup()
    path = str(tmp_path / "ckpt.npz")
    tck.save_npz(path, params, thf.init_state(ravel, config))
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_npz(path, {"only": torch.zeros(3)})


def test_npz_path_normalization(tmp_path):
    params, config, ravel, _, _ = _setup()
    base = str(tmp_path / "ckpt")  # no extension
    tck.save_npz(base, params, thf.init_state(ravel, config))
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    p, _, _ = tck.restore_npz(base, params)
    _assert_trees_equal(params, p)


def test_npz_rejects_wrong_template(tmp_path):
    params, config, ravel, _, _ = _setup()
    path = str(tmp_path / "c.npz")
    tck.save_npz(path, params, thf.init_state(ravel, config))
    leaves = tree_flatten(params)[0]
    with pytest.raises(ValueError, match="structure"):
        tck.restore_npz(path, {f"k{i}": l for i, l in enumerate(leaves)})
    bad_shapes = {"layers": [
        {k: torch.zeros(v.shape + (1,)) for k, v in layer.items()}
        for layer in params["layers"]
    ]}
    with pytest.raises(ValueError, match="shape"):
        tck.restore_npz(path, bad_shapes)


def test_npz_structure_string_is_jaxs(tmp_path):
    """The port writes JAX's structure string, so the JAX package's
    restore_npz (which checks it) reads the port's files."""
    params, config, ravel, step, batch = _setup()
    state = step(params, thf.init_state(ravel, config), batch)[1]
    path = str(tmp_path / "t.npz")
    tck.save_npz(path, params, state, {"init_losses": [2.0]})
    jparams = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), params)
    with np.load(path) as data:
        meta = json.loads(str(data["__meta__"]))
    assert meta["treedef"] == str(jax.tree_util.tree_structure(jparams))
    j_params, j_state, j_hist = jck.restore_npz(path, jparams)
    assert j_hist == {"init_losses": [2.0]}
    assert int(j_state.step_count) == 1
    np.testing.assert_array_equal(np.asarray(j_state.x0), state.x0.numpy())
    for a, b in zip(jax.tree_util.tree_leaves(j_params),
                    tree_flatten(params)[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _jax_run(steps, tmp_path):
    """A JAX run of ``steps`` steps saved with the JAX package's save_npz."""
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal((16, 7)), rng.standard_normal((16, 3))
    jparams = jm.init_mlp(jax.random.PRNGKey(3), dtype=jnp.float64)
    kw = dict(damping=0.5, cg_max_iter=30)
    j_opt = jhf.HessianFree(jparams, model_fn=jm.mlp_apply,
                            loss_outer=jm.mse_loss, **kw)
    for _ in range(steps):
        j_opt.step((jnp.asarray(x), jnp.asarray(y)))
    path = str(tmp_path / "jax.npz")
    j_opt.save(path, backend="npz")
    return j_opt, path, kw, (x, y)


def test_jax_npz_checkpoint_continues_in_the_port(tmp_path):
    """JAX save_npz -> port restore_npz: the port's next steps from the
    file equal the JAX steps from the same file."""
    j_opt, path, kw, (x, y) = _jax_run(2, tmp_path)
    template = params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_opt.params), device="cpu")
    t_opt = thf.HessianFree(template, model_fn=tm.mlp_apply,
                            loss_outer=tm.mse_loss, **kw)
    t_opt.load(path, backend="npz")
    j_fresh = jhf.HessianFree(j_opt.params, model_fn=jm.mlp_apply,
                              loss_outer=jm.mse_loss, **kw)
    j_fresh.load(path, backend="npz")
    assert t_opt.history == j_fresh.history and len(t_opt.history[
        "init_losses"]) == 2
    assert int(t_opt.state.step_count) == 2
    assert t_opt.state.step_count.dtype == torch.int64
    for _ in range(2):
        j_fresh.step((jnp.asarray(x), jnp.asarray(y)))
        t_opt.step((torch.tensor(x), torch.tensor(y)))
    assert_same_step(t_opt, j_fresh, 1e-9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_wrapper_save_load_continues_bitwise(backend, tmp_path):
    params, _, _, _, batch = _setup()
    kw = dict(model_fn=tm.mlp_apply, loss_outer=tm.mse_loss, damping=0.5,
              cg_max_iter=30)
    opt = thf.HessianFree(params, **kw)
    for _ in range(2):
        opt.step(batch)
    path = str(tmp_path / "ckpt")
    opt.save(path, backend=backend)
    fresh = thf.HessianFree(params, **kw)
    fresh.load(path, backend=backend)
    assert fresh.history == opt.history
    for a, b in zip(fresh.state, opt.state):
        assert torch.equal(a, b)
    assert fresh.step(batch) == opt.step(batch)
    _assert_trees_equal(fresh.params, opt.params)
    assert fresh.history == opt.history


def test_wrapper_refuses_unknown_backends(tmp_path):
    params, _, _, _, _ = _setup()
    opt = thf.HessianFree(params, model_fn=tm.mlp_apply,
                          loss_outer=tm.mse_loss)
    for call in (opt.save, opt.load):
        with pytest.raises(ValueError, match="'torch'.*'npz'"):
            call(str(tmp_path / "c"), backend="orbax")
    assert not os.listdir(tmp_path)


def test_package_checkpoint_is_the_module():
    assert thf.checkpoint is tck and "checkpoint" in thf.__all__
    assert thf.checkpoint.save is tck.save
