"""The port's ``parallel/`` package on the CPU: the mesh and process-group
helpers against the JAX package's, the data-parallel builders on two gloo
ranks against JAX's on a 2-device mesh and against the port's one-process
functions, the collectives a step makes, and world size 1 in process.

The two ranks (tests/_torch_dp_worker.py, suite ``other``) run once for
the file on tests/test_parallel.py's MLP problem in f64; the step
parities of every curvature and reduction are in
tests/test_torch_parallel_ggn.py and tests/test_torch_parallel_hessian.py.
"""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dp_parity as parity  # noqa: E402
import _torch_dp_worker as worker  # noqa: E402
import torch.distributed as dist  # noqa: E402

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.parallel import (  # noqa: E402
    data_parallel as jdp,
    distributed as jdist,
    mesh as jmesh,
)
from pytorchhessianfree_tpu_torch.convert import params_from_jax  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    mlp_apply,
    mse_loss,
    mse_loss_sum,
)
from pytorchhessianfree_tpu_torch.parallel import (  # noqa: E402
    data_parallel as tdp,
    distributed as tdist,
    mesh as tmesh,
)

ACC_CASES = [("ggn", "mean", 1), ("hessian", "sum", 0)]


# -- the helpers against JAX, before any group exists ----------------------


@pytest.mark.parametrize("k", [1, 2, 3])
def test_balanced_mesh_shape_matches_jax(k):
    for n in range(1, 17):
        shape = tmesh.balanced_mesh_shape(n, k)
        assert shape == jmesh.balanced_mesh_shape(n, k), n
        assert int(np.prod(shape)) == n
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="Invalid mesh"):
            mod.balanced_mesh_shape(0, k)
        with pytest.raises(ValueError, match="Invalid mesh"):
            mod.balanced_mesh_shape(4, 0)


def test_global_batch_slice_matches_jax():
    """tests/test_distributed.py's fake layouts, and its errors."""
    assert not dist.is_initialized()
    assert tdist.global_batch_slice(64) == slice(0, 64)  # no group: 1 of 1
    for pc in (1, 2, 4, 8):
        slices = [tdist.global_batch_slice(64, pc, i) for i in range(pc)]
        assert slices == [jdist.global_batch_slice(64, pc, i)
                          for i in range(pc)]
        assert [r for s in slices for r in range(s.start, s.stop)] \
            == list(range(64))
    for args in ((65, 4, 0), (64, 4, 4), (64, 0, 0), (64, 2, -1)):
        with pytest.raises(ValueError) as t_err:
            tdist.global_batch_slice(*args)
        with pytest.raises(ValueError) as j_err:
            jdist.global_batch_slice(*args)
        assert str(t_err.value) == str(j_err.value)


def test_initialize_distributed_without_a_group():
    """No arguments and no launcher: a no-op; partial arguments raise; a
    requested backend that cannot form raises and never becomes another."""
    tdist.initialize_distributed()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="together"):
        tdist.initialize_distributed("localhost:1", 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdist.initialize_distributed("localhost:1", 1, 0)
    with pytest.raises(Exception):
        tdist.initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                     backend="nccl", device="cpu")
    assert not dist.is_initialized()
    tdist._device = None


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# -- two gloo ranks ---------------------------------------------------------


def j_fns(reduction, reg):
    return jhf.HFModelFns(model_fn=parity.j_mlp,
                          loss_outer=parity.J_LOSS[reduction],
                          loss_reg=parity.j_reg if reg else None)


def j_config(curvature, reduction="mean"):
    return jhf.HFConfig(curvature_opt=curvature,
                        damping=worker.DAMPING[reduction], cg_max_iter=50)


def references(params, data):
    """JAX's builders on a 2-device mesh and the port's one-process
    functions on the whole batches."""
    mesh = jmesh.make_mesh(2)
    tparams = params_from_jax(params, device="cpu")
    jr, tr = jhf.TrainableRavel(params), thf.TrainableRavel(tparams)
    T = {k: torch.tensor(v) for k, v in data.items()}
    refs = {}
    for reduction in ("mean", "sum"):
        for reg in (0, 1):
            refs[f"diag-{reduction}-{reg}"] = (
                np.asarray(jdp.dp_diag_EF(j_fns(reduction, reg), params,
                                          data["x"], data["y"], reduction,
                                          jr, mesh)),
                thf.diag_EF(mlp_apply, worker.LOSSES[reduction], tparams,
                            T["x"], T["y"], reduction, tr,
                            loss_reg=worker.l2_reg if reg else None).numpy(),
            )
    for curvature, reduction, reg in ACC_CASES:
        jf, jc = j_fns(reduction, reg), j_config(curvature, reduction)
        tf = worker.fns_for(reduction, reg)
        tc = worker.config_for(curvature, reduction)
        j_diag = jdp.dp_diag_EF(jf, params, data["x"], data["y"], reduction,
                                jr, mesh)
        t_diag = thf.diag_EF(mlp_apply, worker.LOSSES[reduction], tparams,
                             T["x"], T["y"], reduction, tr,
                             loss_reg=tf.loss_reg)
        for name in ("gspmd", "shardmap"):
            if name == "gspmd":
                j_step = jdp.make_dp_hf_acc_step(jf, jc, jr, mesh,
                                                 reduction=reduction)
            else:
                j_step = jdp.make_dp_hf_acc_step_shardmap(
                    jf, jc, jr, mesh, reduction=reduction)
            runs = []
            for pkg, step, p, ravel, cx, cy, diag in (
                (jhf, j_step, params, jr, data["cx"], data["cy"], j_diag),
                (thf, lambda p, s, d, **kw: thf.hf_acc_step(
                    p, s, fns=tf, config=tc, ravel=tr, loss_data=d,
                    reduction=reduction, **kw),
                 tparams, tr, T["cx"], T["cy"], t_diag),
            ):
                state = pkg.init_state(ravel, jc if pkg is jhf else tc)
                out = {k: [] for k in ("params", "init_loss", "new_damping",
                                       "num_cg_iters")}
                for i in range(2):
                    kw = {"precond_diag": diag} if i and name == "gspmd" \
                        else {}
                    p, state, stats = step(p, state, (cx, cy), **kw)
                    out["params"].append(np.asarray(ravel.ravel(p)))
                    for k in ("init_loss", "new_damping", "num_cg_iters"):
                        out[k].append(float(getattr(stats, k)))
                runs.append({k: np.array(v) for k, v in out.items()})
            refs[f"acc-{curvature}-{reduction}-{reg}-{name}"] = runs
    for ema in (None, 0.9):
        jf, tf = j_fns("mean", 1), worker.fns_for("mean", True)
        j_loop = jdp.make_dp_hf_train_loop(jf, j_config("ggn"), jr, mesh,
                                           precond_ema_decay=ema)
        t_loop = thf.make_hf_train_loop(tf, worker.config_for("ggn"), tr,
                                        precond_ema_decay=ema)
        jres = j_loop(params, jhf.init_state(jr, j_config("ggn")),
                      (data["xs"], data["ys"]))
        tres = t_loop(tparams, thf.init_state(tr, worker.config_for("ggn")),
                      (T["xs"], T["ys"]))
        refs[f"loop-{ema}"] = [
            {"params": np.asarray(r.ravel(res[0])),
             "num_cg_iters": np.asarray(res[2].num_cg_iters),
             "init_loss": np.asarray(res[2].init_loss)}
            for r, res in ((jr, jres), (tr, tres))
        ]
    return refs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two ranks' results and the references, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("dp_other")
    params, data = parity.other_problem()
    parity.write_problem(tmp / "problem.npz", params, data)
    procs = worker.spawn("other", tmp / "problem.npz", tmp)
    try:
        refs = references(params, data)
        return refs, worker.collect(procs, tmp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("reg", [0, 1])
def test_dp_diag_ef_matches_jax_and_one_process(two_ranks, reduction, reg):
    refs, (r0, r1) = two_ranks
    got = r0[f"diag-{reduction}-{reg}"]
    for ref in refs[f"diag-{reduction}-{reg}"]:
        np.testing.assert_allclose(got, ref, rtol=1e-10)
    np.testing.assert_array_equal(r1[f"diag-{reduction}-{reg}"], got)


@pytest.mark.parametrize("name", ["gspmd", "shardmap"])
@pytest.mark.parametrize("case", ACC_CASES, ids=lambda c: "-".join(map(str, c)))
def test_dp_acc_step_matches_jax_and_one_process(two_ranks, case, name):
    """Both accumulated builders: 2 steps over 2 chunks of 32 rows, each
    chunk split over the ranks (the gspmd case's second step
    preconditioned with the diagonal)."""
    refs, (r0, r1) = two_ranks
    key = f"acc-{'-'.join(map(str, case))}-{name}"
    got = {k: r0[f"{key}/{k}"] for k in ("params", "init_loss",
                                          "new_damping", "num_cg_iters")}
    for ref in refs[key]:
        parity.assert_same_run(got, ref, 2 * worker.LOSS_SCALE[case[1]])
    for k in got:
        np.testing.assert_array_equal(r1[f"{key}/{k}"], got[k])


@pytest.mark.parametrize("ema", [None, 0.9])
def test_dp_train_loop_matches_jax_and_one_process(two_ranks, ema):
    refs, (r0, r1) = two_ranks
    for ref in refs[f"loop-{ema}"]:
        np.testing.assert_array_equal(r0[f"loop-{ema}/num_cg_iters"],
                                      ref["num_cg_iters"])
        np.testing.assert_allclose(r0[f"loop-{ema}/params"], ref["params"],
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(r0[f"loop-{ema}/init_loss"],
                                   ref["init_loss"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(r1[f"loop-{ema}/params"],
                                  r0[f"loop-{ema}/params"])


def test_prefetcher_keeps_the_rank_rows(two_ranks):
    _, ranks = two_ranks
    assert all(bool(r["prefetch/rows_equal"]) for r in ranks)


def test_unstacked_datalist_raises(two_ranks):
    _, ranks = two_ranks
    assert all("STACKED datalist" in str(r["unstacked_error"]) for r in ranks)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_dp_step_collectives(two_ranks, mode):
    """The analog of tests/test_collective_audit.py: one param-sized
    all_reduce per CG iteration (between two kernel launches, nothing
    else), only scalars or trial vectors in the trial walk, and at most 4
    param-sized ones outside the loops (here the gradient and the warm
    start's matvec)."""
    _, ranks = two_ranks
    for r in ranks:
        events = r[f"log-{mode}/events"].tolist()
        iters, dim = int(r[f"log-{mode}/num_cg_iters"]), int(r["dim"])
        launches = [i for i, e in enumerate(events) if e == -1]
        assert len(launches) == iters
        for a, b in zip(launches, launches[1:]):
            assert events[a + 1:b] == [dim]
        before, after = events[:launches[0]], events[launches[-1] + 1:]
        # the first iteration's matvec is the last reduce before the
        # first launch
        assert before[-1] == dim
        outside = before[:-1].count(dim)
        assert outside == 2 and outside <= 4
        assert all(0 < e <= 20 for e in after), after  # [G+1], [max_iter]
        assert all(e in (1, dim) for e in before)
        if mode == "sequential":
            assert set(after) == {1}
        assert sum(e == dim for e in events) == iters + outside


# -- world size 1, in this process ------------------------------------------


@pytest.fixture(scope="module")
def mesh1():
    """A 1-rank mesh: make_mesh in a process without a group forms one in
    memory, on the device initialize_distributed recorded."""
    tdist.initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    mesh = tmesh.make_mesh()
    assert dist.is_initialized() and dist.get_world_size() == 1
    yield mesh
    dist.destroy_process_group()
    tdist._device = None


def mlp_problem():
    params, data = parity.other_problem()
    return (params_from_jax(params, device="cpu"),
            (torch.tensor(data["x"]), torch.tensor(data["y"])))


@pytest.mark.parametrize("curvature", ["ggn", "hessian"])
@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_one_rank_dp_step_is_hf_step(mesh1, curvature, mode):
    params, batch = mlp_problem()
    fns = worker.fns_for("mean", True)
    config = worker.config_for(curvature, backtracking_mode=mode,
                               linesearch=thf.LineSearchConfig(mode=mode))
    ravel = thf.TrainableRavel(params)
    runs = []
    for step in (thf.make_hf_step(fns, config, ravel),
                 tdp.make_dp_hf_step(fns, config, ravel, mesh1)):
        p, state = params, thf.init_state(ravel, config)
        for _ in range(2):
            p, state, stats = step(p, state, batch)
        runs.append((ravel.ravel(p), state, stats))
    (pa, sa, ta), (pb, sb, tb) = runs
    assert torch.equal(pa, pb)
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    assert ta.num_cg_iters == tb.num_cg_iters
    assert torch.equal(ta.init_loss, tb.init_loss)
    assert torch.equal(ta.final_loss, tb.final_loss)


def test_one_rank_wrapper_is_the_plain_wrapper(mesh1):
    params, batch = mlp_problem()
    opts = [thf.HessianFree(params, model_fn=mlp_apply, loss_outer=mse_loss,
                            config=worker.config_for("ggn"), mesh=mesh)
            for mesh in (None, mesh1)]
    for opt in opts:
        d = opt.get_preconditioner(*batch, "mean")
        opt.step(batch, precond_diag=d)
        opt.train_steps(tuple(t[None] for t in batch))
        opt.clear_caches()
    a, b = opts
    assert a.history == b.history
    assert torch.equal(a.ravel.ravel(a.params), b.ravel.ravel(b.params))


def test_wrapper_reads_the_loss_reduction(mesh1):
    """``HessianFree(mesh=)`` reads "mean" or "sum" from the loss and
    refuses a loss that is neither, or a batch it cannot halve."""
    params, batch = mlp_problem()
    kw = dict(model_fn=mlp_apply, config=worker.config_for("ggn"),
              mesh=mesh1)
    for loss, read in ((mse_loss, "mean"), (mse_loss_sum, "sum")):
        opt = thf.HessianFree(params, loss_outer=loss, **kw)
        opt.step(batch)
        assert opt._dp_reduction == read

    def root_loss(out, y):
        return torch.sum((out - y) ** 2) / out.shape[0] ** 0.5

    opt = thf.HessianFree(params, loss_outer=root_loss, **kw)
    with pytest.raises(ValueError, match="neither the mean"):
        opt.step(batch)
    with pytest.raises(ValueError, match="1 row"):
        opt.step(tuple(t[:1] for t in batch))


def test_mesh_and_sharding_helpers(mesh1):
    assert mesh1.mesh_dim_names == ("data",) and mesh1.size(0) == 1
    x = torch.arange(12.0).reshape(6, 2)
    (sx,) = tmesh.shard_batch((x,), mesh1)
    assert torch.equal(sx, x)
    assert tmesh.batch_sharding(mesh1) == tmesh.Sharding(mesh1, "data", 0)
    assert tmesh.replicated(mesh1).axis is None
    assert tmesh.replicated(mesh1).rows(6) == slice(0, 6)
    mesh2 = tmesh.make_mesh(axis_names=("data", "model"))
    assert mesh2.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError, match="rank"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="axes"):
        tmesh.make_mesh(shape=(1, 1))
    with pytest.raises(ValueError, match="cover"):
        tmesh.make_mesh(axis_names=("data", "model"), shape=(1, 2))
    tdist.initialize_distributed()  # a group exists: a no-op


def test_what_the_mesh_refuses(mesh1):
    params, batch = mlp_problem()
    kw = dict(model_fn=mlp_apply, loss_outer=mse_loss)
    # a model axis runs the sharded steps (parallel/sharded.py); specs
    # need a mesh, and a mesh with a model axis
    assert thf.HessianFree(params, mesh=tmesh.make_mesh(
        axis_names=("data", "model")), **kw)._sharded
    with pytest.raises(ValueError, match="require mesh"):
        thf.HessianFree(params, param_specs={}, **kw)
    with pytest.raises(ValueError, match="'model' axis"):
        thf.HessianFree(params, mesh=mesh1,
                        batch_specs=tmesh.PartitionSpec(None, "model"), **kw)
    with pytest.raises(ValueError, match="axis"):
        thf.HessianFree(params, mesh=mesh1, data_axis="batch", **kw)
    opt = thf.HessianFree(params, mesh=mesh1, **kw)
    sketch = opt.get_nystrom_sketch(batch, rank=2)
    with pytest.raises(ValueError, match="precond_lowrank"):
        opt.step(batch, precond_lowrank=sketch)
    with pytest.raises(ValueError, match="closures"):
        opt.step(batch, M=lambda v: v)
    with pytest.raises(ValueError, match="loss_data"):
        opt.acc_step([batch], grad_data=[batch])
    with pytest.raises(ValueError, match="STACKED"):
        opt.acc_step([batch])
    with pytest.raises(ValueError, match="reduction"):
        tdp.make_dp_hf_step(opt.fns, opt.config, opt.ravel, mesh1,
                            reduction="max")
