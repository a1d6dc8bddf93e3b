"""A whole ``make_hf_step`` step of a pipelined decoder LM on four gloo
ranks, a (stage 4) mesh, in f64 (tests/test_pipeline.py:96-123: 15 CG
iterations): the same CG iterations and parameters as the JAX package's
pipelined step and as the port's one-process step of the same model run
in sequence; the four replicas equal bit for bit.

The JAX test holds its pipelined step within atol 1e-9 of its sequential
one.  The port holds its own pair to that bound.  Against the JAX
package's step it holds :data:`JAX_ATOL`: the trajectory amplifies
rounding, so that a relative perturbation of 1e-15 of the start moves the
port's one-process step by 2.2e-10, and the port's one-process step lies
3.5e-9 from the JAX package's pipelined one (f64, CPU), beyond 1e-9
whatever the schedule does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_pipeline_parity as parity  # noqa: E402
import _torch_pipeline_worker as worker  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    decoder_lm_apply,
    next_token_loss,
)

JAX_ATOL = 1e-8  # module docstring


def one_process_step(problem):
    """The port's ``hf_step`` of the same model with its blocks in
    sequence, in this process."""
    params, tokens = worker.problem(problem, "step")
    config = thf.HFConfig(damping=1.0, cg_max_iter=worker.STEP_CG)
    ravel = thf.TrainableRavel(params)
    fns = thf.HFModelFns(
        model_fn=lambda p, t: decoder_lm_apply(p, t, n_heads=worker.N_HEADS),
        loss_outer=next_token_loss)
    p, _, st = thf.hf_step(params, thf.init_state(ravel, config),
                           (tokens, tokens), fns=fns, config=config,
                           ravel=ravel)
    return {"step/params": ravel.ravel(p).numpy(),
            "step/num_cg_iters": st.num_cg_iters}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return parity.run(tmp_path_factory.mktemp("pipeline_step"), ("step",),
                      meanwhile=one_process_step)


@pytest.mark.parametrize("reference", ["jax", "one_process"])
def test_hf_step_follows_the_reference(ranks, reference):
    got, want, one = ranks
    ref, atol = (want, JAX_ATOL) if reference == "jax" else (one, 1e-9)
    assert int(got[0]["step/num_cg_iters"]) == int(ref["step/num_cg_iters"])
    np.testing.assert_allclose(got[0]["step/params"], ref["step/params"],
                               rtol=0, atol=atol)


def test_ranks_are_bitwise_equal(ranks):
    parity.assert_ranks_equal(ranks[0])
