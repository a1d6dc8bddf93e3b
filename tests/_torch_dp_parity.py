"""Shared parts of the 2-rank data-parallel parity tests
(tests/test_torch_parallel_ggn.py, tests/test_torch_parallel_hessian.py):
the port's data-parallel step on two gloo ranks against the JAX package's
``make_dp_hf_step`` / ``make_dp_hf_step_shardmap`` on a 2-device mesh and
against the port's ``hf_step`` on the whole batch, in f64.

The MLP problem is tests/test_parallel.py's (its weights and 3 batches of
32 rows, ``HFConfig(damping=0.5, cg_max_iter=50)``, 3 steps), for the GGN
and the Hessian, the "mean" and "sum" losses, with and without an L2
``loss_reg``.  Two ranks run every case once for the file
(tests/_torch_dp_worker.py, one suite per curvature), each feeding its 16
rows; the tolerances are tests/test_parallel.py's, and the two ranks'
parameters must be equal bit for bit.

The "sum" runs scale the damping with the loss, to 0.5 x 96 (32 rows x 3
outputs), so that their damped systems are conditioned as the "mean" ones
are.  At damping 0.5 the sum-loss GGN system is 96 times worse
conditioned, CG's rounding grows over its 25-27 iterations, and JAX's own
``make_dp_hf_step`` and ``make_hf_step`` end 3e-4 apart in the parameters
after 3 steps: no pair of implementations meets 1e-8 there.  The loss's
absolute tolerance scales with it too (1e-10 x 96).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_dp_worker as worker
import pytorchhessianfree_tpu as jhf
import pytorchhessianfree_tpu_torch as thf
from pytorchhessianfree_tpu.models.mlp import (
    init_mlp as j_init_mlp,
    mlp_apply as j_mlp,
    mse_loss as j_mse,
    mse_loss_sum as j_mse_sum,
)
from pytorchhessianfree_tpu.parallel.data_parallel import (
    make_dp_hf_step as j_dp_step,
    make_dp_hf_step_shardmap as j_dp_step_shardmap,
)
from pytorchhessianfree_tpu.parallel.mesh import make_mesh as j_make_mesh
from pytorchhessianfree_tpu_torch.convert import params_from_jax

J_LOSS = {"mean": j_mse, "sum": j_mse_sum}


def cases(curvature):
    """``(curvature, reduction, reg, builder)`` for every reduction, with
    and without ``loss_reg``, and both builders."""
    return [(curvature, r, g, b) for r in ("mean", "sum") for g in (0, 1)
            for b in ("gspmd", "shardmap")]


def _draw(seed, N=32):
    """tests/test_parallel.py's ``_problem``."""
    kp, kx, ky = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (j_init_mlp(kp, dtype=jnp.float64),
            jax.random.normal(kx, (N, 7), jnp.float64),
            jax.random.normal(ky, (N, 3), jnp.float64))


def problem():
    """tests/test_parallel.py's weights (seed 0) and batches (seeds 1-3),
    as numpy arrays that both packages read."""
    params = jax.tree_util.tree_map(np.asarray, _draw(0)[0])
    batches = [_draw(i + 1)[1:] for i in range(3)]
    data = {"xs": np.stack([np.asarray(x) for x, _ in batches]),
            "ys": np.stack([np.asarray(y) for _, y in batches])}
    return params, data


def other_problem():
    """:func:`problem` and a fourth batch ``x``, ``y`` (seed 4) and two
    stacked chunks ``cx``, ``cy`` (seeds 5, 6) of 32 rows each."""
    params, data = problem()
    x, y = (np.asarray(a) for a in _draw(4)[1:])
    chunks = [_draw(5 + c)[1:] for c in range(2)]
    data.update(x=x, y=y, cx=np.stack([np.asarray(a) for a, _ in chunks]),
                cy=np.stack([np.asarray(b) for _, b in chunks]))
    return params, data


def write_problem(path, params, data):
    arrays = dict(data)
    for i, layer in enumerate(params["layers"]):
        arrays[f"w{i}"], arrays[f"b{i}"] = layer["w"], layer["b"]
    np.savez(path, **arrays)


def run_all(suite, tmp):
    """Start the two ranks of ``suite`` on :func:`problem`, run every
    case's JAX and one-process references meanwhile, and return
    ``({case: (jax, port)}, [rank 0, rank 1])``."""
    write_problem(tmp / "problem.npz", *problem())
    procs = worker.spawn(suite, tmp / "problem.npz", tmp)
    try:
        params, data = problem()
        refs = {case: (jax_run(case, params, data), port_run(*case[:3]))
                for case in cases(suite)}
        return refs, worker.collect(procs, tmp)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def j_reg(params):
    return 1e-3 * sum(jnp.sum(layer["w"] ** 2) for layer in params["layers"])


def jax_run(case, params, data):
    curvature, reduction, reg, builder = case
    fns = jhf.HFModelFns(model_fn=j_mlp, loss_outer=J_LOSS[reduction],
                         loss_reg=j_reg if reg else None)
    config = jhf.HFConfig(curvature_opt=curvature,
                          damping=worker.DAMPING[reduction], cg_max_iter=50)
    ravel = jhf.TrainableRavel(params)
    mesh = j_make_mesh(2)
    if builder == "gspmd":
        step = j_dp_step(fns, config, ravel, mesh)
    else:
        step = j_dp_step_shardmap(fns, config, ravel, mesh,
                                  reduction=reduction)
    return run(step, ravel, params, jhf.init_state(ravel, config), data,
               jnp.asarray)


@functools.lru_cache(maxsize=None)
def port_run(curvature, reduction, reg):
    """The port's ``hf_step`` on the whole batches (shared by the two
    builders' cases)."""
    params, data = problem()
    fns = worker.fns_for(reduction, reg)
    config = worker.config_for(curvature, reduction)
    tparams = params_from_jax(params, device="cpu")
    ravel = thf.TrainableRavel(tparams)
    step = thf.make_hf_step(fns, config, ravel)
    return run(step, ravel, tparams, thf.init_state(ravel, config), data,
               torch.tensor)


def run(step, ravel, params, state, data, to):
    out = {k: [] for k in ("params", "init_loss", "new_damping",
                           "num_cg_iters")}
    for x, y in zip(data["xs"], data["ys"]):
        params, state, stats = step(params, state, (to(x), to(y)))
        out["params"].append(np.asarray(ravel.ravel(params)))
        for k in ("init_loss", "new_damping", "num_cg_iters"):
            out[k].append(float(getattr(stats, k)))
    return {k: np.array(v) for k, v in out.items()}


def assert_same_run(got, ref, loss_scale=1):
    """tests/test_parallel.py's tolerances, step by step; the loss's scaled
    by ``loss_scale``."""
    np.testing.assert_array_equal(got["num_cg_iters"], ref["num_cg_iters"])
    np.testing.assert_allclose(got["params"], ref["params"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got["init_loss"], ref["init_loss"], rtol=0,
                               atol=1e-10 * loss_scale)
    np.testing.assert_allclose(got["new_damping"], ref["new_damping"],
                               rtol=1e-12)


def check_case(results, case):
    """One case's run on the two ranks against JAX and the one-process
    port, and the ranks against each other, bit for bit."""
    refs, (r0, r1) = results
    j, one = refs[case]
    key = "-".join(map(str, case))
    got = {k: r0[f"{key}/{k}"] for k in ("params", "init_loss",
                                          "new_damping", "num_cg_iters")}
    scale = worker.LOSS_SCALE[case[1]]
    assert_same_run(got, j, scale)
    assert_same_run(got, one, scale)
    for k in got:
        np.testing.assert_array_equal(r1[f"{key}/{k}"], got[k])
