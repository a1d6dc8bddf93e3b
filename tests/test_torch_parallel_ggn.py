"""The port's data-parallel step with GGN curvature on two gloo ranks
against JAX's ``make_dp_hf_step`` / ``make_dp_hf_step_shardmap`` on a
2-device mesh and the port's one-process ``hf_step``, for both reductions,
with and without ``loss_reg`` (tests/_torch_dp_parity.py says how)."""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dp_parity as parity  # noqa: E402

CASES = parity.cases("ggn")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return parity.run_all("ggn", tmp_path_factory.mktemp("dp_ggn"))


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_two_rank_steps_match_jax_and_one_process(results, case):
    parity.check_case(results, case)
