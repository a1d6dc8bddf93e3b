"""``HessianFree(mesh=)`` and a row-coupling model on two gloo ranks.

The two ranks (tests/_torch_dp_worker.py, suite ``wrapper``) run once for
the file on tests/test_parallel.py's MLP problem in f64:

- the wrapper with a "mean" and a "sum" loss (a diagonal, a preconditioned
  step, an accumulated step, 3 train steps), held against the JAX
  package's ``HessianFree(mesh=make_mesh(2))`` making the same calls on the
  whole batches and against the port's wrapper in one process.  The JAX
  package's GSPMD step takes the reduction from the loss; the port's
  wrapper reads it from the loss's values;
- 3 steps of an MLP whose hidden layers are normalized by the batch's
  statistics through the ``shard_map`` name, held against JAX's
  ``make_dp_hf_step_shardmap`` on ``make_mesh(2)`` (each shard normalized
  by its own statistics, as on the ranks) and against the port's
  ``hf_acc_step`` in one process with the two shards as chunks;
- the same 3 steps through the GSPMD name (fault F2, repaired): the
  statistics are the whole batch's, held against JAX's
  ``make_dp_hf_step`` on ``make_mesh(2)`` and the port's ``hf_step`` on
  the whole batch; and the GSPMD train loop with an EMA diagonal and the
  accumulated step against one process on the whole batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dp_parity as parity  # noqa: E402
import _torch_dp_worker as worker  # noqa: E402
import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.parallel import (  # noqa: E402
    data_parallel as jdp,
    mesh as jmesh,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import mlp_apply  # noqa: E402

REDUCTIONS = ["mean", "sum"]


def j_bn_mlp(params, x):
    """tests/_torch_dp_worker.py's ``bn_mlp_apply`` in JAX."""
    layers = params["layers"]
    for layer in layers[:-1]:
        h = x @ layer["w"] + layer["b"]
        c = h - jnp.mean(h, 0)
        x = jnp.tanh(c / jnp.sqrt(jnp.mean(c * c, 0) + 1e-5))
    return x @ layers[-1]["w"] + layers[-1]["b"]


def references(params, data):
    mesh = jmesh.make_mesh(2)
    tparams = params_from_jax(params, device="cpu")
    T = {k: torch.tensor(v) for k, v in data.items()}
    refs = {}
    for reduction in REDUCTIONS:
        j_opt = jhf.HessianFree(
            params, model_fn=parity.j_mlp,
            loss_outer=parity.J_LOSS[reduction], loss_reg=parity.j_reg,
            config=jhf.HFConfig(curvature_opt="ggn",
                                damping=worker.DAMPING[reduction],
                                cg_max_iter=50),
            pad_to_multiple=None, mesh=mesh)
        t_opt = thf.HessianFree(
            tparams, model_fn=mlp_apply, loss_outer=worker.LOSSES[reduction],
            loss_reg=worker.l2_reg, config=worker.config_for("ggn", reduction),
            pad_to_multiple=None)
        refs[f"wrapper-{reduction}"] = [
            worker.wrapper_calls(opt, (d["x"], d["y"]), (d["cx"], d["cy"]),
                                 (d["xs"], d["ys"]), reduction)
            for opt, d in ((j_opt, data), (t_opt, T))
        ]

    j_fns = jhf.HFModelFns(model_fn=j_bn_mlp, loss_outer=parity.J_LOSS["mean"])
    j_config = jhf.HFConfig(curvature_opt="ggn",
                            damping=worker.DAMPING["mean"], cg_max_iter=50)
    jr = jhf.TrainableRavel(params)
    j_step = jdp.make_dp_hf_step_shardmap(j_fns, j_config, jr, mesh,
                                          reduction="mean")
    j_run = parity.run(j_step, jr, params, jhf.init_state(jr, j_config),
                       data, jnp.asarray)
    t_fns = thf.HFModelFns(model_fn=worker.bn_mlp_apply,
                           loss_outer=worker.LOSSES["mean"])
    t_config = worker.config_for("ggn")
    tr = thf.TrainableRavel(tparams)

    def halves_step(p, state, batch):
        # the ranks' two shards of 16 rows as two chunks
        return thf.hf_acc_step(
            p, state, fns=t_fns, config=t_config, ravel=tr,
            loss_data=tuple(t.reshape(2, 16, -1) for t in batch))

    t_run = parity.run(halves_step, tr, tparams, thf.init_state(tr, t_config),
                       data, torch.tensor)
    refs["bn"] = [j_run, t_run]

    j_gspmd = jdp.make_dp_hf_step(j_fns, j_config, jr, mesh)
    whole = thf.make_hf_step(t_fns, t_config, tr)
    refs["bn-gspmd"] = [
        parity.run(j_gspmd, jr, params, jhf.init_state(jr, j_config), data,
                   jnp.asarray),
        parity.run(whole, tr, tparams, thf.init_state(tr, t_config), data,
                   torch.tensor)]
    T = {k: torch.tensor(v) for k, v in data.items()}
    loop = thf.make_hf_train_loop(t_fns, t_config, tr, precond_ema_decay=0.9)
    p, _, st, _ = loop(tparams, thf.init_state(tr, t_config),
                       (T["xs"], T["ys"]))
    refs["bn-loop"] = {"params": tr.ravel(p).numpy(),
                       "num_cg_iters": st.num_cg_iters.numpy()}
    p, _, st = thf.hf_acc_step(tparams, thf.init_state(tr, t_config),
                               fns=t_fns, config=t_config, ravel=tr,
                               loss_data=(T["cx"], T["cy"]))
    refs["bn-acc"] = {"params": tr.ravel(p).numpy(),
                      "num_cg_iters": np.array(st.num_cg_iters)}
    return refs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' results and the references, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("dp_wrapper")
    params, data = parity.other_problem()
    parity.write_problem(tmp / "problem.npz", params, data)
    procs = worker.spawn("wrapper", tmp / "problem.npz", tmp)
    try:
        refs = references(params, data)
        return refs, worker.collect(procs, tmp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_wrapper_with_mesh_matches_jax_and_one_process(two_ranks, reduction):
    """``HessianFree(mesh=)``: get_preconditioner, a preconditioned step,
    an accumulated step and 3 train_steps, against JAX's wrapper on a
    2-device mesh and the port's in one process; the reduction it read
    from the loss is the loss's."""
    refs, (r0, r1) = two_ranks
    key = f"wrapper-{reduction}"
    for rank in (r0, r1):
        assert str(rank[f"{key}/read"]) == reduction
    for ref in refs[key]:
        np.testing.assert_array_equal(r0[f"{key}/num_cg_iters"],
                                      ref["num_cg_iters"])
        np.testing.assert_allclose(r0[f"{key}/diag"], ref["diag"],
                                   rtol=1e-10)
        np.testing.assert_allclose(r0[f"{key}/params"], ref["params"],
                                   rtol=0, atol=1e-8)
    np.testing.assert_array_equal(r1[f"{key}/params"], r0[f"{key}/params"])


def test_row_coupling_model_matches_jax_shardmap(two_ranks):
    """Batch statistics per rank: JAX's ``shard_map`` step on a 2-device
    mesh and one process's accumulated step over the two shards give the
    ranks' numbers (ROADMAP.md, fault F2: the JAX package's GSPMD step
    would normalize by the whole batch's statistics)."""
    refs, (r0, r1) = two_ranks
    got = {k: r0[f"bn/{k}"] for k in ("params", "init_loss", "new_damping",
                                      "num_cg_iters")}
    for ref in refs["bn"]:
        parity.assert_same_run(got, ref)
    for k in got:
        np.testing.assert_array_equal(r1[f"bn/{k}"], got[k])


def test_row_coupling_model_gspmd_uses_the_whole_batch(two_ranks):
    """Fault F2, repaired: through the GSPMD name the ranks' BatchNorm
    statistics are the whole batch's, so JAX's ``make_dp_hf_step`` on a
    2-device mesh and the port's ``hf_step`` on the whole batch give the
    ranks' numbers."""
    refs, (r0, r1) = two_ranks
    got = {k: r0[f"bn-gspmd/{k}"] for k in ("params", "init_loss",
                                            "new_damping", "num_cg_iters")}
    for ref in refs["bn-gspmd"]:
        parity.assert_same_run(got, ref)
    for k in got:
        np.testing.assert_array_equal(r1[f"bn-gspmd/{k}"], got[k])


@pytest.mark.parametrize("key", ["bn-loop", "bn-acc"])
def test_row_coupling_model_gspmd_loop_and_acc_step(two_ranks, key):
    """The GSPMD train loop with an EMA diagonal (per-sample gradients see
    each sample alone) and the GSPMD accumulated step (each chunk's
    statistics over both ranks' rows) equal one process on the whole
    batches."""
    refs, (r0, r1) = two_ranks
    np.testing.assert_array_equal(r0[f"{key}/num_cg_iters"],
                                  refs[key]["num_cg_iters"])
    np.testing.assert_allclose(r0[f"{key}/params"], refs[key]["params"],
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(r1[f"{key}/params"], r0[f"{key}/params"])
