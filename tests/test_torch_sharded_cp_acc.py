"""Context parallelism through the accumulated step and the train loop,
on four gloo ranks, a (data 2, model 2) mesh, on
tests/test_sharded.py's decoder LMs, in f64.

the tokens' sequence axis split over the model axis (``batch_specs=P(None,
"model")``) through ``make_sharded_hf_acc_step`` (``acc_cp``) and
``make_sharded_hf_train_loop`` (``loop_cp``), the stacked chunk or time
axis prepended unsplit.

Each case against the JAX package's ``make_sharded_hf_*`` on
a (2, 2) mesh and the port's one-process step
(tests/_torch_sharded_parity.py), the four ranks' parameters equal bit for
bit.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402

WORLD = 4
CASES = ["acc_cp", "loop_cp"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return parity.run_all(CASES, tmp_path_factory.mktemp("sharded_cp_acc"),
                          WORLD)


@pytest.mark.parametrize("case", CASES)
def test_sharded_lm_case_matches_jax_and_one_process(four_ranks, case):
    parity.check(four_ranks, case)
