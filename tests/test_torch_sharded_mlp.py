"""The solver-state-sharded steps on four gloo ranks, a (data 2, model 2)
mesh, on tests/test_sharded.py's MLP, in f64.

The ranks (tests/_torch_sharded_worker.py) run each case once for the
file; each case is held against the JAX package's ``make_sharded_hf_*``
on a (2, 2) mesh of the virtual CPU devices and against the port's
one-process step, at tests/test_sharded.py's tolerances, and the four
ranks' parameters must be equal bit for bit
(tests/_torch_sharded_parity.py).  ``mlp_tp`` is
tests/test_sharded.py:138-168: every layer's ``w`` under ``P(None,
"model")`` and ``b`` under ``P("model")``, 2 steps; each rank computes
its layers' output columns (``models/mlp.py``), so its forward does half
of one process's matmul FLOPs on the same rows and the step holds the
column blocks alone.  Also: the builders' validation, and the blocks
each rank keeps of a batch under per-leaf, tree-prefix and stacked
``batch_specs``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402
import _torch_sharded_worker as worker  # noqa: E402

WORLD = 4
CASES = ["ggn", "hessian", "precond", "model_only", "rich", "acc", "loop",
         "loop_ema", "mlp_tp"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return parity.run_all(CASES + ["validation", "placement"],
                          tmp_path_factory.mktemp("sharded_mlp"), WORLD)


@pytest.mark.parametrize("case", CASES)
def test_sharded_case_matches_jax_and_one_process(four_ranks, case):
    parity.check(four_ranks, case)


def test_sharded_state_and_ema_are_model_blocks(four_ranks):
    """The warm start a loop returns is the rank's block of n / 2."""
    _, ranks = four_ranks
    for case in ("loop", "loop_ema"):
        n = ranks[0][f"{case}/params"].shape[-1]
        assert tuple(ranks[0][f"{case}/x0_shape"]) == (n // 2,)


def test_column_parallel_mlp_splits_the_matmuls(four_ranks):
    """Each rank's forward under the column specs: its layers' matmuls on
    ``d_out / 2`` columns, exactly half of one process's FLOPs on the same
    rows, and the columns gathered (one gather per layer)."""
    _, ranks = four_ranks
    sizes = worker.SIZES
    for r in ranks:
        rows = int(r["mlp_tp/rows"])
        tp, one = (int(f) for f in r["mlp_tp/flops"])
        whole = sum(2 * rows * a * b for a, b in zip(sizes, sizes[1:]))
        assert one == whole and 2 * tp == whole, (tp, one, whole)
        assert int(r["mlp_tp/tp_gathers"]) > 0


def test_column_parallel_mlp_keeps_column_blocks(four_ranks):
    """Inside the step each rank holds the ``[d_in, d_out / 2]`` and
    ``[d_out / 2]`` blocks of every layer: the model function receives
    them, the local tree holds exactly their entries, and no op builds a
    whole flat vector."""
    parity.check_blocks(four_ranks, "mlp_tp", parity.tensor_split)


def test_sharded_validation(four_ranks):
    _, ranks = four_ranks
    no_axis, not_divisible = ranks[0]["validation/errors"]
    assert "no axis named" in no_axis
    assert "not divisible" in not_divisible
    assert "pad_to_multiple" in not_divisible


def test_batch_specs_tree_prefix_and_stacked(four_ranks):
    """Rank (d, m) keeps rows 4d:4d+4 and columns 2m:2m+2 of x under
    P("data", "model"); the None leaf inherits the data split; P()
    replicates; one spec covers the tree; a stacked leaf keeps its leading
    axis whole."""
    _, ranks = four_ranks
    x = np.arange(32.0).reshape(8, 4)
    y = np.arange(8.0)
    xs = np.arange(96.0).reshape(3, 8, 4)
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 2)
        rows, cols = slice(4 * d, 4 * d + 4), slice(2 * m, 2 * m + 2)
        np.testing.assert_array_equal(r["place/xy"], np.concatenate(
            [x[rows, cols].ravel(), y[rows], y]))
        np.testing.assert_array_equal(r["place/tree"], np.concatenate(
            [x[rows].ravel(), x[rows].ravel()]))
        np.testing.assert_array_equal(r["place/stacked"], xs[:, rows, cols])
