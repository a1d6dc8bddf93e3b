"""Pipeline parallelism composed with the model axis, and the probe of the
schedule's collectives.

- tests/test_pipeline.py:141-189 on a (stage 2, model 2) mesh of four gloo
  ranks, in f64: ``make_sharded_hf_step(..., data_axis=None,
  model_axis="model")`` over the pipelined decoder LM takes the JAX
  package's step on the same mesh shape (4 of the 8 virtual CPU devices,
  ``pad_to_multiple=8``): the same CG iterations and parameters within
  atol 1e-9, the warm start a block of half the flat vector, the replicas
  equal bit for bit;
- the probe, on two gloo ranks: ``ppermute`` against the joined program of
  the ranks, and a two-stage ``pipeline_blocks`` of a small nonlinear
  block (through ``copy_to_axis``, ``ppermute`` and ``reduce_from_axis``)
  against the blocks run in sequence in one process, under ``jvp``,
  ``linearize`` (20 replays), ``vjp``, the vjp of a jvp, the Hessian
  forward over reverse, reverse over reverse and linearized, and ``vmap``
  of a jvp (tests/_torch_pipeline_worker.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_dp_worker as dp_worker  # noqa: E402
import _torch_pipeline_parity as parity  # noqa: E402
import _torch_pipeline_worker as worker  # noqa: E402

PROBE = {"jvp": ("value", "jvp"), "linearize": ("linearize",),
         "vjp": ("vjp",), "vjp_of_jvp": ("vjp_of_jvp",),
         "hessian": ("grad", "hvp_fwd_rev", "hvp_rev_rev",
                     "hvp_linearized"),
         "vmap_jvp": ("vmap_jvp",)}
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = tmp_path_factory.mktemp("pipeline_probe")
    procs = dp_worker.spawn_script(
        worker.__file__, [str(two / "none"), str(two), "probe"], 2)
    try:
        sharded = parity.run(tmp_path_factory.mktemp("pipeline_sharded"),
                             ("sharded",))
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return sharded, (dp_worker.collect(procs, two), worker.probe_expected(2))


def test_composition_follows_the_jax_sharded_step(runs):
    got, want = runs[0]
    r = got[0]
    assert int(r["sharded/num_cg_iters"]) == int(want["sharded/num_cg_iters"])
    n = want["sharded/params"].size
    np.testing.assert_allclose(r["sharded/params"][:n],
                               want["sharded/params"], rtol=0, atol=1e-9)
    assert int(r["sharded/x0_size"]) == r["sharded/params"].size // 2


def test_composition_replicas_are_bitwise_equal(runs):
    parity.assert_ranks_equal(runs[0][0])


@pytest.mark.parametrize("check", sorted(PROBE))
@pytest.mark.parametrize("program", ["ppermute", "pipeline"])
def test_probe(runs, program, check):
    got, want = runs[1]
    for key in PROBE[check]:
        key = f"{program}/{key}"
        np.testing.assert_allclose(np.stack([r[key] for r in got]),
                                   want[key], err_msg=key, **TOL)
