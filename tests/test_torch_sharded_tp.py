"""Tensor parallelism on four gloo ranks, a (data 2, model 2) mesh: the
encoder classifier of tests/test_sharded.py under its Megatron
``param_specs`` (tests/test_sharded.py:316-331: QKV and FF1 split by
column, proj and FF2 by row, over the model axis), in f64.  Each rank
keeps its blocks between steps and the step gathers them, and each rank's
forward computes its heads and feed-forward columns (Megatron tensor
parallelism, tests/test_torch_sharded_megatron.py); 2 steps against
the JAX package's ``make_sharded_hf_step`` on a (2, 2) mesh and the port's
one-process step, at 2e-6 then 1e-5: the trajectory moves by 6.7e-7 after
one step under a 1e-15 perturbation of the start
(tests/_torch_sharded_parity.py).  The four ranks' parameters are equal
bit for bit.

Also on the same ranks: ``HessianFree(mesh=, batch_specs=P(None,
"model"))`` on the decoder LM (context parallelism through the wrapper, 2
steps at 1e-7; the JAX package's partitioner aborts on this layout over a
(1, 2) mesh, so it runs here), its refusals of ``batch_specs`` without a
model axis, and spec trees converted from the JAX package's.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402
import _torch_sharded_worker as worker  # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return parity.run_all(["tp", "wrap_cp"],
                          tmp_path_factory.mktemp("sharded_tp"), WORLD)


@pytest.mark.parametrize("case", ["tp", "wrap_cp"])
def test_tp_and_wrapper_match_jax_and_one_process(four_ranks, case):
    parity.check(four_ranks, case)


def test_megatron_step_partitions_the_blocks(four_ranks):
    """The Megatron specs set the model axis as the forward's tensor axis:
    the step's forwards sum each sub-layer's partial over it."""
    _, ranks = four_ranks
    assert all(r["tp/tp_sums"] > 0 for r in ranks)
    assert ranks[0]["wrap_cp/tp_sums"] == 0


def test_megatron_blocks_are_kept_sharded(four_ranks):
    """The step returns each rank's Megatron blocks: qkv's w [16, 48] by
    column, proj's w [16, 16] by row."""
    _, ranks = four_ranks
    shapes = eval(str(ranks[0]["tp/shapes"]))
    assert (16, 24) in shapes and (8, 16) in shapes
    assert (16, 48) not in shapes


def test_spec_trees_convert_from_jax():
    """``convert.specs_from_jax`` maps the JAX package's spec tree to the
    port's by field."""
    from pytorchhessianfree_tpu_torch.convert import specs_from_jax

    assert specs_from_jax(parity.to_jax_specs(worker.MEGATRON)) \
        == worker.MEGATRON


def test_wrapper_refuses_batch_specs_without_a_model_axis(four_ranks):
    _, ranks = four_ranks
    errors = list(ranks[0]["wrap_cp/errors"])
    assert len(errors) == 2
    assert all("batch_specs require" in e for e in errors)
