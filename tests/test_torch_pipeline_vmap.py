"""``vmap`` through a pipelined decoder LM in the optimizer's own uses, on
two gloo ranks, a (stage 2) mesh, in f64 (tests/test_pipeline.py's draw
of its HF step, 4 layers as 2 per stage, 2 microbatches):

- a short step with the batched CG backtracking and line search (one
  ``vmap`` sweep of the loss over the candidates each) against the port's
  one-process step of the blocks in sequence: the same CG iterations and
  parameters within tests/test_pipeline.py's atol 1e-9;
- the linearized GGN matvec ``vmap``ped over 3 probes (the form the
  Nystrom sketch and SLQ take) against the matvec of each probe, within
  rtol 1e-12;
- the two replicas equal bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dp_worker as dp_worker  # noqa: E402
import _torch_pipeline_parity as parity  # noqa: E402
import _torch_pipeline_worker as worker  # noqa: E402
import pytorchhessianfree_tpu_torch as thf  # noqa: E402
from pytorchhessianfree_tpu_torch.models import (  # noqa: E402
    decoder_lm_apply,
    next_token_loss,
)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_vmap")
    path = tmp / "problem.npz"
    parity.write_problem(path, ("step",))
    procs = dp_worker.spawn_script(worker.__file__,
                                   [str(path), str(tmp), "vmap"], 2)
    try:
        one = worker.batched_step(thf.HFModelFns(
            model_fn=lambda p, t: decoder_lm_apply(p, t,
                                                   n_heads=worker.N_HEADS),
            loss_outer=next_token_loss), np.load(path))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return dp_worker.collect(procs, tmp), one


def test_batched_selection_step_follows_the_one_process_step(ranks):
    got, one = ranks
    r = got[0]
    assert int(r["vmap/num_cg_iters"]) == int(one["vmap/num_cg_iters"])
    np.testing.assert_allclose(r["vmap/params"], one["vmap/params"].numpy(),
                               rtol=0, atol=1e-9)


def test_vmapped_matvec_equals_the_matvec_of_each_probe(ranks):
    r = ranks[0][0]
    np.testing.assert_allclose(r["vmap/matvecs"], r["vmap/looped"],
                               rtol=1e-12, atol=1e-13)


def test_ranks_are_bitwise_equal(ranks):
    parity.assert_ranks_equal(ranks[0])
