"""The sharded steps on two gloo ranks, a (data 1, model 2) mesh, in f64:
tests/test_sharded.py's MLP steps for the GGN and the Hessian (3 steps)
and its accumulated step; the wrapper ``HessianFree(mesh=)`` (2 steps, a
diagonal, an accumulated step, and its refusal of independent
datalists).  Expert parallelism is in tests/test_torch_sharded_ep.py.

Each case against the JAX package's ``make_sharded_hf_*`` (or wrapper) on
a (1, 2) mesh of the virtual CPU devices and the port's one-process step
(tests/_torch_sharded_parity.py); the two ranks' parameters equal bit for
bit.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 2
CASES = ["ggn", "hessian", "acc", "wrap"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return parity.run_all(CASES, tmp_path_factory.mktemp("sharded_model2"),
                          WORLD)


@pytest.mark.parametrize("case", CASES)
def test_model_axis_case_matches_jax_and_one_process(two_ranks, case):
    parity.check(two_ranks, case)


def test_wrapper_state_is_a_block_and_refuses_datalists(two_ranks):
    _, ranks = two_ranks
    n = ranks[0]["wrap/params"].shape[-1]
    assert tuple(ranks[0]["wrap/x0_shape"]) == (n // 2,)
    (error,) = ranks[0]["wrap/errors"]
    assert "only loss_data" in error
