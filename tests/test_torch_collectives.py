"""The differentiable collectives (``parallel/collectives.py``) on two gloo
ranks against one process over the joined inputs, in f64.

Two ranks run tests/_torch_collectives_worker.py once for the file.  The
joined program maps every rank's input to every rank's output; each
rank's derivatives must equal that program's, restricted to the rank's
own inputs (``_torch_collectives_worker.expected``), for:

- ``jvp`` and ``linearize`` (replayed 20 times with rank-dependent
  tangents: an in-place ``dist.all_reduce`` in the forward replays
  racily, returning the rank's own term unreduced in some replays);
- ``vjp``, the vjp of a jvp, and Hessian-vector products forward over
  reverse, reverse over reverse and linearized (the functional
  collective with a separate ``wait_tensor`` got the linearized one
  wrong);
- ``vmap`` of a jvp;
- ``all_gather`` (value, jvp, vjp as a reduce-scatter, vmap) and
  ``split`` as its adjoint across the sharded and replicated inner
  products.

tests/test_torch_cuda.py runs the same checks on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_collectives_worker as worker  # noqa: E402
import _torch_dp_worker as dp_worker  # noqa: E402

WORLD = 2
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    procs = dp_worker.spawn_script(worker.__file__, [str(tmp)], WORLD)
    return dp_worker.collect(procs, tmp), worker.expected(WORLD)


def check(ranks, keys):
    got, want = ranks
    for key in keys:
        np.testing.assert_allclose(np.stack([r[key] for r in got]),
                                   want[key], err_msg=key, **TOL)


def test_value_jvp_and_vjp(ranks):
    check(ranks, ("value", "jvp", "vjp"))


def test_linearize_replays_twenty_times(ranks):
    """Every one of the 20 replays, each with its own tangent per rank,
    equals the joined jvp (the in-place collective failed 2 of 4)."""
    check(ranks, ("linearize",))
    assert ranks[0][0]["linearize"].shape[0] == worker.REPLAYS == 20


def test_vjp_of_jvp(ranks):
    """d/dx of sum_r <u_r, J t>: rules that call the in-place op directly
    give half of it, since autograd does not see the reduce inside."""
    check(ranks, ("vjp_of_jvp",))


def test_hessian_orders_agree_with_the_joined_hessian(ranks):
    check(ranks, ("grad", "hvp_fwd_rev", "hvp_rev_rev", "hvp_linearized"))


def test_vmap_of_jvp(ranks):
    check(ranks, ("vmap_jvp",))


def test_all_gather_and_split_are_adjoint(ranks):
    check(ranks, ("gather", "gather_jvp", "gather_vjp", "gather_vmap"))
    for r in ranks[0]:
        np.testing.assert_allclose(r["pair_gather"], r["pair_split"], **TOL)


def test_one_rank_calls_the_functions_alike(tmp_path):
    """On one rank the worker calls the ``Function``s directly (as the
    card test does under NCCL at world size 1): every check holds."""
    procs = dp_worker.spawn_script(worker.__file__, [str(tmp_path)], 1)
    check((dp_worker.collect(procs, tmp_path), worker.expected(1)),
          worker.expected(1).keys())
