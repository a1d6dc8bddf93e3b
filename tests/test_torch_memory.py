"""Solver sizing (``pytorchhessianfree_tpu_torch.utils.memory``) against the
JAX package's ``solver_memory_bytes`` on the buffers both packages hold in
the same way, the port's own counts where they differ, and the estimate
against the bytes a step's solver allocates on the CPU."""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

import pytorchhessianfree_tpu as jhf  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu.utils.memory import (  # noqa: E402
    solver_memory_bytes as j_memory,
)
from pytorchhessianfree_tpu_torch import optimizer  # noqa: E402
from pytorchhessianfree_tpu_torch.utils.memory import (  # noqa: E402
    format_solver_memory,
    solver_memory_bytes,
)
from test_torch_remat_bf16 import _cpu_peak_bytes  # noqa: E402

# the fields both packages count alike (the grid as the default
# store_mode="cond" lays it out)
SAME = ("flat_dim", "vector_bytes", "iterate_grid_rows", "iterate_grid_bytes")
RESNET18_PARAMS, RESNET18_DIM = 11_175_370, 11_175_936


def _ravels(n, pad=1024, dtype="float32"):
    jr = jhf.TrainableRavel({"w": jnp.zeros(n, dtype)}, pad_to_multiple=pad)
    tr = thf.TrainableRavel({"w": torch.empty(n, dtype=getattr(torch, dtype))},
                            pad_to_multiple=pad)
    return jr, tr


def _configs(**kwargs):
    store = kwargs.pop("store_dtype", None)
    return (jhf.HFConfig(cg=jhf.CGConfig(store_dtype=store), **kwargs),
            thf.HFConfig(cg=thf.CGConfig(store_dtype=store), **kwargs))


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(cg_max_iter=50),
    dict(cg_max_iter=50, store_dtype="bfloat16"),
    dict(cg_max_iter=7, use_cg_backtracking=False),
    dict(cg_max_iter=50, precond="diag_ef"),
    dict(cg_max_iter=None, dtype="float64"),
])
def test_fields_held_alike_match_jax(kwargs):
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", "float32")
    jr, tr = _ravels(3000, dtype=dtype)
    jc, tc = _configs(**kwargs)
    j, t = j_memory(jr, jc), solver_memory_bytes(tr, tc)
    assert set(t) == set(j)
    for key in SAME:
        assert t[key] == j[key], key
    # the port's eager CG keeps 10 flat vectors (11 preconditioned) where
    # the JAX loop keeps 6, and a preconditioner's diagonal and scale
    pre = tc.precond != "none"
    assert t["cg_vectors_bytes"] == (10 + pre) * t["vector_bytes"]
    assert t["precond_diag_bytes"] == 2 * pre * t["vector_bytes"]
    assert t["total"] == t["per_device"] == (
        t["cg_vectors_bytes"] + t["iterate_grid_bytes"]
        + t["precond_diag_bytes"])


def test_no_scratch_row_in_the_port():
    """``store_mode`` is a no-op in the port: no scratch row is counted."""
    jr, tr = _ravels(3000)
    j = j_memory(jr, jhf.HFConfig(cg_max_iter=50,
                                  cg=jhf.CGConfig(store_mode="scratch")))
    t = solver_memory_bytes(tr, thf.HFConfig(
        cg_max_iter=50, cg=thf.CGConfig(store_mode="scratch")))
    assert t["iterate_grid_rows"] == j["iterate_grid_rows"] - 1 == len(
        thf.storing_grid(50))


def test_resnet18_bf16_rows_save_half_the_grid():
    """ResNet-18's flat dimension at ``cg_max_iter=50``: 13 grid rows; bf16
    storage saves 13 x n x 2 bytes, in both packages."""
    jr, tr = _ravels(RESNET18_PARAMS)
    totals = {}
    for store in (None, "bfloat16"):
        jc, tc = _configs(cg_max_iter=50, store_dtype=store)
        t = solver_memory_bytes(tr, tc)
        assert t["flat_dim"] == RESNET18_DIM and t["iterate_grid_rows"] == 13
        totals[store] = (t["total"], j_memory(jr, jc)["total"])
    saved = 13 * RESNET18_DIM * 2
    assert totals[None][0] - totals["bfloat16"][0] == saved == 290_574_336
    assert totals[None][1] - totals["bfloat16"][1] == saved


def test_format_and_refusals():
    _, tr = _ravels(RESNET18_PARAMS)
    text = format_solver_memory(tr, thf.HFConfig(cg_max_iter=50))
    assert text.splitlines() == [
        "flat dim 11,175,936 (42.6 MB/vector)",
        "CG vectors: 426.3 MB",
        "iterate grid [13 rows]: 554.2 MB",
        "total: 980.6 MB",
    ]
    assert "precond diagonal: 85.3 MB" in format_solver_memory(
        tr, thf.HFConfig(cg_max_iter=50, precond="diag_ef"))
    # over a model axis: each rank's blocks and three whole vectors
    one = solver_memory_bytes(tr, thf.HFConfig(cg_max_iter=50))
    two = solver_memory_bytes(tr, thf.HFConfig(cg_max_iter=50),
                              model_axis_size=2)
    assert two["total"] == one["total"]
    assert two["per_device"] == one["total"] // 2 + 3 * one["vector_bytes"]
    assert format_solver_memory(
        tr, thf.HFConfig(cg_max_iter=50), model_axis_size=2
    ).splitlines()[-1] == "per device (model axis 2): 618.2 MB"
    with pytest.raises(ValueError):
        solver_memory_bytes(tr, thf.HFConfig(), model_axis_size=0)


def test_estimate_bounds_what_the_solver_allocates():
    """The solver phase of a step (``_step_core``: CG with the fused
    update, backtracking, line search) on a diagonal system: the peak of
    its CPU allocations above what existed before it is the estimate's
    flat vectors and grid rows, less the two that existed already."""
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    d = torch.rand(n, generator=gen) * 100 + 1
    g = torch.randn(n, generator=gen)
    params = {"w": torch.zeros(n)}
    ravel = thf.TrainableRavel(params)
    config = thf.HFConfig(damping=1.0, cg_max_iter=50)
    state = thf.init_state(ravel, config)

    def loss_at(delta):
        return 0.5 * torch.dot(delta, d * delta) + torch.dot(g, delta)

    def run():
        optimizer._step_core(
            config, ravel, params, state, init_loss=torch.zeros(()),
            grad_vec=g, mvp_vec=lambda v: d * v, loss_at=loss_at, M=None)

    peak = _cpu_peak_bytes(run)
    est = solver_memory_bytes(ravel, config)
    vec = est["vector_bytes"]
    assert est["iterate_grid_rows"] == 13
    assert est["total"] == (10 + 13) * vec
    # g and the warm start exist before the step, and the estimate counts
    # them; the rest it counts to within CG's scalars and m-history
    assert abs(peak - (est["total"] - 2 * vec)) < 0.01 * vec, (peak / vec)
