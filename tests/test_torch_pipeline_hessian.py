"""The Hessian matvec (forward over reverse, ``ops.curvature.hvp_fn``, a
gradient linearized through the schedule's collectives) of a pipelined
decoder LM on four gloo ranks, a (stage 4) mesh, in f64, against the JAX
package's own ``pipeline_blocks`` (tests/test_pipeline.py:214-237, its
draws and tolerances; tests/_torch_pipeline_parity.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_pipeline_parity as parity  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return parity.run(tmp_path_factory.mktemp("pipeline_hvp"), ("hvp",))


def test_loss_matches_jax(ranks):
    got, want = ranks
    np.testing.assert_allclose(got[0]["hvp/loss"], want["hvp/loss"],
                               rtol=1e-13)


@pytest.mark.parametrize("key", ["hvp/grad", "hvp/hvp"])
def test_gradient_and_hessian_matvec_match_jax(ranks, key):
    got, want = ranks
    np.testing.assert_allclose(got[0][key], want[key], rtol=1e-10,
                               atol=1e-11)


def test_ranks_are_bitwise_equal(ranks):
    parity.assert_ranks_equal(ranks[0])
