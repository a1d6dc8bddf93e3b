"""Expert parallelism on two gloo ranks, a (data 1, model 2) mesh: the MoE
decoder LM of 4 experts under ``moe_param_specs`` (each rank keeps and
runs 2 experts; the router and the dispatch stay replicated; one
``all_reduce`` per layer sums the combine), 2 steps in f64 against the JAX
package's ``make_sharded_hf_step`` under its ``moe_param_specs`` on a
(1, 2) mesh and the port's one-process step, at 1e-8 then 1e-6
(tests/_torch_sharded_parity.py); the two ranks' parameters equal bit for
bit.  At the same bounds, where the model axis's roles meet:

- ``moe_cp``: the MoE LM under context parallelism (``batch_specs=P(None,
  "model")``, no expert specs), its loss adding ``0.01 * aux`` as
  examples_torch/run_moe_lm.py does; the feed-forward routes the gathered
  positions as one process does, and the draws drop choices by capacity
  (asserted on one process's forward), so routing each rank's positions
  alone would not match;
- ``moe_cp_ep``: the same under ``moe_param_specs`` too (CP + EP);
- ``ep_diag``: EP with ``HFConfig(precond="diag_ef")``, 1 step: the
  in-step empirical-Fisher diagonal of whole per-sample gradients (F3).

Inside the steps of ``ep`` and ``moe_cp_ep`` each rank holds its 2
experts' leaves alone: the model function receives them, the local tree
holds exactly their entries, and no op builds a whole flat vector.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 2


JOINED = ["moe_cp", "moe_cp_ep", "ep_diag"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return parity.run_all(["ep"] + JOINED,
                          tmp_path_factory.mktemp("sharded_ep"), WORLD)


def test_expert_parallel_step_matches_jax_and_one_process(two_ranks):
    parity.check(two_ranks, "ep")


@pytest.mark.parametrize("case", JOINED)
def test_joined_roles_match_jax_and_one_process(two_ranks, case):
    parity.check(two_ranks, case)


@pytest.mark.parametrize("case", ["moe_cp", "moe_cp_ep"])
def test_context_parallel_moe_draws_drop_choices(two_ranks, case):
    """The capacity drops choices in one process's forward of the draw."""
    refs, _ = two_ranks
    assert refs[case][1]["dropped"] > 0


def test_expert_blocks_are_kept_sharded(two_ranks):
    """Each rank keeps 2 of the 4 experts' w1 [4, 16, 32]."""
    _, ranks = two_ranks
    assert "(2, 16, 32)" in str(ranks[0]["ep/shapes"])
    assert "(4, 16, 32)" not in str(ranks[0]["ep/shapes"])


@pytest.mark.parametrize("case", ["ep", "moe_cp_ep"])
def test_step_keeps_expert_blocks(two_ranks, case):
    """Inside the step each rank holds 2 of the 4 experts' leaves and the
    rest whole: the model function receives them so, the local tree holds
    exactly that many entries, and no op builds a whole flat vector."""
    parity.check_blocks(two_ranks, case, parity.expert_split)
