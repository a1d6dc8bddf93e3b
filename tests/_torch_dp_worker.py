"""One rank of the port's data-parallel parity runs, on the CPU over gloo.

Started twice (:func:`spawn`) by tests/test_torch_parallel.py,
tests/test_torch_parallel_ggn.py and tests/test_torch_parallel_hessian.py::

    python tests/_torch_dp_worker.py RANK WORLD PORT PROBLEM.npz OUT_DIR SUITE

Each rank joins a ``WORLD``-rank gloo group on ``localhost:PORT``, reads
the problem (a small f64 MLP, its batches and datalists, written with
numpy by the test), feeds only its own rows of every batch
(``shard_batch``) and writes ``OUT_DIR/rank{RANK}.npz``.  Suites:

- ``ggn`` and ``hessian``: 3 data-parallel steps with that curvature for
  each reduction ("mean", "sum"), with and without ``loss_reg``, through
  both builders (``make_dp_hf_step``, ``make_dp_hf_step_shardmap``);
- ``other``: ``dp_diag_EF``, the accumulated step through both builders,
  the train loop with and without an EMA preconditioner,
  ``DevicePrefetcher(sharding=)``, and the log of every ``all_reduce`` and
  CG-kernel launch of one step in each select mode;
- ``wrapper``: the ``HessianFree(mesh=)`` wrapper with a "mean" and a
  "sum" loss, and 3 data-parallel steps of an MLP with batch-normalized
  hidden layers (a forward that couples the rows).

It imports no JAX.
"""

import os
import random
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    mlp_apply,
    mse_loss,
    mse_loss_sum,
)
from pytorchhessianfree_tpu_torch.ops import cg as cg_mod  # noqa: E402
from pytorchhessianfree_tpu_torch.parallel import (  # noqa: E402
    collectives,
    data_parallel as dp,
)
from pytorchhessianfree_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_distributed,
)
from pytorchhessianfree_tpu_torch.parallel.mesh import (  # noqa: E402
    Sharding,
    batch_sharding,
    make_mesh,
    shard_batch,
)
from pytorchhessianfree_tpu_torch.runtime import DevicePrefetcher  # noqa: E402

LOSSES = {"mean": mse_loss, "sum": mse_loss_sum}
BUILDERS = {"gspmd": dp.make_dp_hf_step,
            "shardmap": dp.make_dp_hf_step_shardmap}
ACC_BUILDERS = {"gspmd": dp.make_dp_hf_acc_step,
                "shardmap": dp.make_dp_hf_acc_step_shardmap}


def l2_reg(params):
    return 1e-3 * sum(torch.sum(layer["w"] ** 2)
                      for layer in params["layers"])


def load_problem(path):
    """The MLP's layers (``w0``, ``b0``, ...) and the data arrays."""
    z = {k: torch.tensor(v) for k, v in np.load(path).items()}
    n_layers = sum(k.startswith("w") for k in z)
    params = {"layers": [{"w": z.pop(f"w{i}"), "b": z.pop(f"b{i}")}
                         for i in range(n_layers)]}
    return params, z


def fns_for(reduction, reg):
    return thf.HFModelFns(model_fn=mlp_apply, loss_outer=LOSSES[reduction],
                          loss_reg=l2_reg if reg else None)


# the "sum" loss of a batch of 32 rows x 3 outputs is 96 times the "mean"
# one, and so is its damping: the damped systems are then conditioned alike
LOSS_SCALE = {"mean": 1, "sum": 96}
DAMPING = {k: 0.5 * v for k, v in LOSS_SCALE.items()}


def config_for(curvature, reduction="mean", **kwargs):
    return thf.HFConfig(curvature_opt=curvature,
                        damping=DAMPING[reduction], cg_max_iter=50, **kwargs)


def record(out, key, ravel, params_per_step, stats_per_step):
    out[f"{key}/params"] = np.stack(
        [ravel.ravel(p).numpy() for p in params_per_step])
    for name in ("init_loss", "final_loss", "new_damping", "num_cg_iters"):
        out[f"{key}/{name}"] = np.array(
            [float(getattr(s, name)) for s in stats_per_step])


def suite_steps(curvature, mesh, params, data, out):
    xs, ys = data["xs"], data["ys"]  # [3, N, ...]: one batch per step
    for reduction in ("mean", "sum"):
        for reg in (False, True):
            fns = fns_for(reduction, reg)
            config = config_for(curvature, reduction)
            ravel = thf.TrainableRavel(params)
            for name, build in BUILDERS.items():
                step = build(fns, config, ravel, mesh,
                             reduction=reduction)
                p, state = params, thf.init_state(ravel, config)
                ps, ss = [], []
                for i in range(xs.shape[0]):
                    batch = shard_batch((xs[i], ys[i]), mesh)
                    p, state, stats = step(p, state, batch)
                    ps.append(p)
                    ss.append(stats)
                record(out, f"{curvature}-{reduction}-{int(reg)}-{name}",
                       ravel, ps, ss)


class Log:
    """Every ``all_reduce`` (its element count) and CG-kernel launch
    (-1), in order."""

    def __init__(self):
        self.events = None
        self._all_reduce = dist.all_reduce
        self._update = cg_mod.fused_cg_update

    def __enter__(self):
        self.events = []

        def all_reduce(tensor, *args, **kwargs):
            self.events.append(tensor.numel())
            return self._all_reduce(tensor, *args, **kwargs)

        def update(*args):
            self.events.append(-1)
            return self._update(*args)

        dist.all_reduce = all_reduce
        cg_mod.fused_cg_update = update
        return self

    def __exit__(self, *exc):
        dist.all_reduce = self._all_reduce
        cg_mod.fused_cg_update = self._update


def suite_other(mesh, params, data, out):
    x, y = data["x"], data["y"]  # one global batch [N, ...]
    local = shard_batch((x, y), mesh)
    ravel = thf.TrainableRavel(params)

    for reduction in ("mean", "sum"):
        for reg in (False, True):
            out[f"diag-{reduction}-{int(reg)}"] = dp.dp_diag_EF(
                fns_for(reduction, reg), params, *local, reduction, ravel,
                mesh).numpy()

    # stacked datalists: each chunk's rows split over the ranks
    cx, cy = data["cx"], data["cy"]  # [C, N, ...]
    sharding = Sharding(mesh, "data", dim=1)
    chunks = (sharding.take(cx).contiguous(), sharding.take(cy).contiguous())
    for curvature, reduction, reg in (("ggn", "mean", True),
                                      ("hessian", "sum", False)):
        fns = fns_for(reduction, reg)
        config = config_for(curvature, reduction)
        diag = dp.dp_diag_EF(fns, params, *local, reduction, ravel, mesh)
        for name, build in ACC_BUILDERS.items():
            step = build(fns, config, ravel, mesh, reduction=reduction)
            p, state, ps, ss = params, thf.init_state(ravel, config), [], []
            for i in range(2):
                kwargs = {"precond_diag": diag} if i and name == "gspmd" \
                    else {}
                p, state, stats = step(p, state, chunks, **kwargs)
                ps.append(p)
                ss.append(stats)
            record(out, f"acc-{curvature}-{reduction}-{int(reg)}-{name}",
                   ravel, ps, ss)
    try:
        dp.make_dp_hf_acc_step(fns, config, ravel, mesh)(
            params, thf.init_state(ravel, config),
            [(local[0], local[1])])
    except ValueError as e:
        out["unstacked_error"] = np.array(str(e))

    # the train loop: T steps of this rank's rows of each step's batch
    xs, ys = data["xs"], data["ys"]
    batches = (sharding.take(xs).contiguous(),
               sharding.take(ys).contiguous())
    for ema in (None, 0.9):
        fns, config = fns_for("mean", True), config_for("ggn")
        loop = dp.make_dp_hf_train_loop(fns, config, ravel, mesh,
                                        precond_ema_decay=ema)
        state = thf.init_state(ravel, config)
        res = loop(params, state, batches)
        out[f"loop-{ema}/params"] = ravel.ravel(res[0]).numpy()
        out[f"loop-{ema}/num_cg_iters"] = res[2].num_cg_iters.numpy()
        out[f"loop-{ema}/init_loss"] = res[2].init_loss.numpy()

    # the prefetcher keeps this rank's rows of each global batch
    with DevicePrefetcher(iter([(x.numpy(), y.numpy())] * 2),
                          sharding=batch_sharding(mesh)) as pf:
        got = list(pf)
    out["prefetch/rows_equal"] = np.array(len(got) == 2 and all(
        torch.equal(a, b) for batch in got for a, b in zip(batch, local)))

    # the collectives of one step in each select mode
    for mode in ("sequential", "batched"):
        config = config_for("ggn", backtracking_mode=mode,
                            linesearch=thf.LineSearchConfig(mode=mode))
        step = dp.make_dp_hf_step(fns_for("mean", True), config, ravel, mesh)
        with Log() as log:
            _, _, stats = step(params, thf.init_state(ravel, config), local)
        out[f"log-{mode}/events"] = np.array(log.events)
        out[f"log-{mode}/num_cg_iters"] = np.array(stats.num_cg_iters)
    out["dim"] = np.array(ravel.dim)


def bn_mlp_apply(params, x):
    """``mlp_apply`` with each hidden pre-activation normalized by the
    batch's statistics (BatchNorm without scale or shift): a forward that
    couples the rows of its batch.  The statistics come from
    ``collectives.batch_mean``, as ``models.resnet.batchnorm``'s do: over
    every rank's rows under the GSPMD-named steps."""
    layers = params["layers"]
    for layer in layers[:-1]:
        h = x @ layer["w"] + layer["b"]
        c = h - collectives.batch_mean(h, (0,))
        x = torch.tanh(c / torch.sqrt(collectives.batch_mean(c * c, (0,))
                                      + 1e-5))
    return x @ layers[-1]["w"] + layers[-1]["b"]


def wrapper_calls(opt, local, chunks, batches, reduction):
    """The calls that the wrapper's parity runs make, here and in the test:
    a diagonal, a step preconditioned with it, an accumulated step and a
    train loop of 3 steps."""
    d = opt.get_preconditioner(*local, reduction)
    opt.step(local, precond_diag=d)
    opt.acc_step(chunks, reduction=reduction)
    opt.train_steps(batches)
    return {"params": np.asarray(opt.ravel.ravel(opt.params)),
            "num_cg_iters": np.array(opt.history["num_cg_iters"]),
            "diag": np.asarray(d)}


def suite_wrapper(mesh, params, data, out):
    local = shard_batch((data["x"], data["y"]), mesh)
    sharding = Sharding(mesh, "data", dim=1)
    chunks, batches = ((sharding.take(data[a]).contiguous(),
                        sharding.take(data[b]).contiguous())
                       for a, b in (("cx", "cy"), ("xs", "ys")))
    # the wrapper reads each loss's reduction from the loss
    for reduction in ("mean", "sum"):
        opt = thf.HessianFree(params, model_fn=mlp_apply,
                              loss_outer=LOSSES[reduction], loss_reg=l2_reg,
                              config=config_for("ggn", reduction),
                              pad_to_multiple=None, mesh=mesh)
        res = wrapper_calls(opt, local, chunks, batches, reduction)
        for k, v in res.items():
            out[f"wrapper-{reduction}/{k}"] = v
        out[f"wrapper-{reduction}/read"] = np.array(opt._dp_reduction)

    # the shard_map name: each rank normalizes its own rows; the GSPMD
    # name: every rank's rows together, as one process normalizes the
    # whole batch
    fns = thf.HFModelFns(model_fn=bn_mlp_apply, loss_outer=mse_loss)
    config = config_for("ggn")
    ravel = thf.TrainableRavel(params)
    for key, build in (("bn", dp.make_dp_hf_step_shardmap),
                       ("bn-gspmd", dp.make_dp_hf_step)):
        step = build(fns, config, ravel, mesh)
        p, state, ps, ss = params, thf.init_state(ravel, config), [], []
        for x, y in zip(data["xs"], data["ys"]):
            p, state, stats = step(p, state, shard_batch((x, y), mesh))
            ps.append(p)
            ss.append(stats)
        record(out, key, ravel, ps, ss)
    # the GSPMD train loop with its EMA diagonal (per-sample gradients of
    # samples alone) and the accumulated step
    loop = dp.make_dp_hf_train_loop(fns, config, ravel, mesh,
                                    precond_ema_decay=0.9)
    res = loop(params, thf.init_state(ravel, config), batches)
    out["bn-loop/params"] = ravel.ravel(res[0]).numpy()
    out["bn-loop/num_cg_iters"] = res[2].num_cg_iters.numpy()
    p, _, st = dp.make_dp_hf_acc_step(fns, config, ravel, mesh)(
        params, thf.init_state(ravel, config), chunks)
    out["bn-acc/params"] = ravel.ravel(p).numpy()
    out["bn-acc/num_cg_iters"] = np.array(st.num_cg_iters)


def spawn(suite, problem_path, out_dir, world=2):
    """Start ``world`` ranks of ``suite`` on a free local port, one
    PyTorch thread each; returns their processes."""
    return spawn_script(os.path.abspath(__file__),
                        [str(problem_path), str(out_dir), suite], world)


def free_port():
    """A free local port below Linux's default ephemeral range (32768 on):
    the system hands ephemeral ports to other sockets (the gloo pairs of
    other tests' ranks among them), so one that ``bind(0)`` picked can be
    taken before rank 0 binds it, and the ranks then wait on a stranger."""
    rng = random.SystemRandom()
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
        return port
    raise RuntimeError("no free local port in [20000, 32768)")


def spawn_script(script, args, world=2):
    """Start ``world`` ranks of ``script RANK WORLD PORT *args`` on a free
    local port, one PyTorch thread each; returns their processes."""
    port = free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [
        subprocess.Popen(
            [sys.executable, str(script), str(rank), str(world), str(port),
             *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for rank in range(world)
    ]


def collect(procs, out_dir, timeout=240):
    """Wait for the ranks (killing all if one outlasts ``timeout``), check
    that each finished, and load their results."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs += [q.communicate()[0] for q in procs[len(outs):]]
            raise RuntimeError(
                f"a rank outlasted {timeout} s; their output:\n"
                + "\n".join(f"-- rank {r}:\n{out[-2000:]}"
                             for r, out in enumerate(outs)))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        assert f"rank {rank}/{len(procs)}" in out, out[-3000:]
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    problem_path, out_dir, suite = sys.argv[4:7]
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh()
    params, data = load_problem(problem_path)
    out = {}
    if suite == "other":
        suite_other(mesh, params, data, out)
    elif suite == "wrapper":
        suite_wrapper(mesh, params, data, out)
    else:
        suite_steps(suite, mesh, params, data, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    print(f"rank {rank}/{world} [{suite}]: ok")


if __name__ == "__main__":
    main()
