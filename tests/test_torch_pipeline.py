"""Pipeline parallelism (``parallel/pipeline.py``) on four gloo ranks, a
(stage 4) mesh, in f64, against the JAX package's own ``pipeline_blocks``
on 4 of the 8 virtual CPU devices: the forward, loss, gradient and GGN
matvec, the forwards at 1 and 4 microbatches and with remat, the two
``ValueError``s, and the shifts of a pass.

Four ranks run tests/_torch_pipeline_worker.py once for the file on the
JAX draws of tests/test_pipeline.py while the test process computes the
JAX values (tests/_torch_pipeline_parity.py); the tolerances are
tests/test_pipeline.py's.  The Hessian matvec, the HF step and the
composition with the model axis are in tests/test_torch_pipeline_*.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_pipeline_parity as parity  # noqa: E402
import _torch_pipeline_worker as worker  # noqa: E402

WORLD = 4
CASES = ("fwd", "micro", "errors", "count")
# tests/test_pipeline.py's tolerances
FWD = dict(rtol=1e-12, atol=1e-13)
DERIV = dict(rtol=1e-10, atol=1e-11)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return parity.run(tmp_path_factory.mktemp("pipeline"), CASES, WORLD)


def test_forward_loss_gradient_and_ggn_matvec(ranks):
    got, want = ranks
    r = got[0]
    np.testing.assert_allclose(r["fwd/out"], want["fwd/out"], **FWD)
    np.testing.assert_allclose(r["fwd/loss"], want["fwd/loss"], rtol=1e-13)
    for key in ("fwd/grad", "fwd/ggn"):
        np.testing.assert_allclose(r[key], want[key], err_msg=key, **DERIV)


@pytest.mark.parametrize("name", sorted(worker.MICRO))
def test_microbatch_counts_and_remat(ranks, name):
    got, want = ranks
    key = f"micro/{name}"
    np.testing.assert_allclose(got[0][key], want[key], err_msg=key, **FWD)


def test_errors(ranks):
    got, _ = ranks
    layers, micro = got[0]["errors"]
    assert layers == "3 layers do not divide over 4 pipeline stages"
    assert micro == "batch 4 does not divide into 3 microbatches"


def test_ranks_are_bitwise_equal(ranks):
    parity.assert_ranks_equal(ranks[0])


def test_shifts_per_pass_follow_the_bubble_model(ranks):
    """M + S - 1 = 5 ticks per forward, each shifting one [N / M, T, d]
    microbatch; a gradient adds the inverse shifts of the 4 ticks whose
    result the next tick reads (no tick reads the last one's)."""
    got, _ = ranks
    M, S = 2, WORLD
    forward, gradient = got[0]["count/forward"], got[0]["count/gradient"]
    assert forward.shape == (M + S - 1, 3)
    assert (forward == (4 // M, 8, 16)).all()
    assert gradient.shape == (2 * (M + S - 1) - 1, 3)
    assert (gradient == (4 // M, 8, 16)).all()
