"""Context parallelism on four gloo ranks, a (data 2, model 2) mesh, on
tests/test_sharded.py's decoder LMs, in f64:

- ``cp``: the tokens' sequence axis split over the model axis
  (``batch_specs=P(None, "model")``): attention gathers keys and values,
  the next-token shift crosses the shard boundary (1e-8, then 1e-6);
- ``cp2d``: the one-hot embedding and loss with the tokens split over both
  axes (``P("data", "model")``).

Each case against the JAX package's ``make_sharded_hf_step`` on a (2, 2)
mesh and the port's one-process step (tests/_torch_sharded_parity.py),
the four ranks' parameters equal bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 4
CASES = ["cp", "cp2d"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return parity.run_all(CASES, tmp_path_factory.mktemp("sharded_cp"),
                          WORLD)


@pytest.mark.parametrize("case", CASES)
def test_context_parallel_step_matches_jax_and_one_process(four_ranks, case):
    parity.check(four_ranks, case)
