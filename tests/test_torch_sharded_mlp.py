"""The solver-state-sharded steps on four gloo ranks, a (data 2, model 2)
mesh, on tests/test_sharded.py's MLP, in f64.

The ranks (tests/_torch_sharded_worker.py) run each case once for the
file; each case is held against the JAX package's ``make_sharded_hf_*``
on a (2, 2) mesh of the virtual CPU devices and against the port's
one-process step, at tests/test_sharded.py's tolerances, and the four
ranks' parameters must be equal bit for bit
(tests/_torch_sharded_parity.py).  Also: the builders' validation, and
the blocks each rank keeps of a batch under per-leaf, tree-prefix and
stacked ``batch_specs``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 4
CASES = ["ggn", "hessian", "precond", "model_only", "rich", "acc", "loop",
         "loop_ema"]


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
