"""Expert parallelism on two gloo ranks, a (data 1, model 2) mesh: the MoE
decoder LM of 4 experts under ``moe_param_specs`` (each rank keeps and
runs 2 experts; the router and the dispatch stay replicated; one
``all_reduce`` per layer sums the combine), 2 steps in f64 against the JAX
package's ``make_sharded_hf_step`` under its ``moe_param_specs`` on a
(1, 2) mesh and the port's one-process step, at 1e-8 then 1e-6
(tests/_torch_sharded_parity.py); the two ranks' parameters equal bit for
bit.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 2


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return parity.run_all(["ep"], tmp_path_factory.mktemp("sharded_ep"),
                          WORLD)


def test_expert_parallel_step_matches_jax_and_one_process(two_ranks):
    parity.check(two_ranks, "ep")


def test_expert_blocks_are_kept_sharded(two_ranks):
    """Each rank keeps 2 of the 4 experts' w1 [4, 16, 32]."""
    _, ranks = two_ranks
    assert "(2, 16, 32)" in str(ranks[0]["ep/shapes"])
    assert "(4, 16, 32)" not in str(ranks[0]["ep/shapes"])
