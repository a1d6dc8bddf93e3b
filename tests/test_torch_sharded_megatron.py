"""Megatron tensor parallelism on four gloo ranks, a (data 2, model 2)
mesh, in f64: under the Megatron ``param_specs`` of
tests/test_sharded.py:316-331 (QKV and FF1 split by column, proj and FF2
by row) each rank of the model axis computes its heads and its ``d_ff /
M`` feed-forward columns, with one sum over the axis per sub-layer
(``models/transformer.py``), as GSPMD partitions the JAX package's step.

- ``HessianFree(mesh=, param_specs=)`` on tests/test_sharded.py's encoder:
  2 steps against the JAX package's wrapper on a (2, 2) mesh and the
  port's one-process wrapper at 2e-6 then 1e-5 (the bounds of
  tests/test_torch_sharded_tp.py, which tests/_torch_sharded_parity.py
  explains), the same CG iterations, the four ranks bit for bit;
- loss, gradient, GGN and Hessian matvecs of the partitioned forward
  within 1e-10 of one process's: the encoder, the causal decoder LM with
  full and chunked attention, rematerialized blocks (the one-shot
  matvecs) and the MoE LM's attention; a head count the axis does not
  divide computes that sub-layer whole and gives the same values;
- what is split: a block's matmul FLOPs on a rank are half of one
  process's (``FlopCounterMode``), and its activations hold half the
  heads and half the feed-forward columns;
- the refusals of Megatron blocks beside context or expert parallelism.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

import _torch_sharded_parity as parity  # noqa: E402
import _torch_sharded_worker as worker  # noqa: E402

WORLD = 4
N, T, D, D_FF, HEADS = 16, 8, 16, 32, 4  # the encoder of test_sharded.py
SPLIT = ["enc", "dec", "dec_chunk", "dec_remat", "moe"]
WHOLE = ["heads1", "odd"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return parity.run_all(["wrap_tp", "mega", "split", "refuse"],
                          tmp_path_factory.mktemp("sharded_megatron"), WORLD)


def test_wrapper_megatron_steps_match_jax_and_one_process(four_ranks):
    parity.check(four_ranks, "wrap_tp")
    _, ranks = four_ranks
    assert ranks[0]["wrap_tp/tp_sums"] > 0  # the blocks were partitioned


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kind, curvature", [
    (kind, curvature) for kind in SPLIT + WHOLE
    for curvature in worker.megatron_curvatures(kind)])
def test_partitioned_derivatives_match_one_process(four_ranks, kind,
                                                   curvature):
    _, ranks = four_ranks
    key = f"mega/{kind}/{curvature}"
    holders = [r for r in ranks if f"{key}/loss" in r]
    assert len(holders) == 2  # one model-axis group of the mesh
    (one,) = [r for r in holders if f"{key}/loss_one" in r]
    for name in ("loss", "grad", "mvp"):
        got, want = holders[0][f"{key}/{name}"], one[f"{key}/{name}_one"]
        assert _rel(got, want) <= 1e-10, (name, _rel(got, want))
        np.testing.assert_array_equal(holders[1][f"{key}/{name}"], got)
    sums = int(holders[0][f"{key}/sums"])
    if kind == "odd":  # 3 heads and d_ff 33 over 2 ranks: nothing split
        assert sums == 0
    else:  # heads1: the MLP alone is split; moe: the attention alone
        assert sums > 0


def test_a_rank_computes_half_of_a_block(four_ranks):
    _, ranks = four_ranks
    for r in ranks:
        tp, one = (int(r[f"split/{k}/block_flops"]) for k in ("tp", "one"))
        assert tp > 0 and 2 * tp == one
        # the embedding and the head stay whole: a little over half
        tp, one = (int(r[f"split/{k}/forward_flops"]) for k in ("tp", "one"))
        assert one / 2 < tp < one


def test_block_activations_hold_the_rank_share(four_ranks):
    _, ranks = four_ranks
    tp = set(ranks[0]["split/tp/shapes"])
    one = set(ranks[0]["split/one/shapes"])
    half = HEADS // 2
    # the fused QKV activation: 3 d / M columns, never 3 d
    assert f"add{(N, T, 3 * D // 2)}" in tp
    assert not any(s.endswith(f"{(N, T, 3 * D)}") for s in tp)
    assert any(s.endswith(f"{(N, T, 3 * D)}") for s in one)
    # FF1 through GELU: d_ff / M columns
    assert {s for s in tp if s.startswith("gelu(")} \
        == {f"gelu{(N, T, D_FF // 2)}"}
    assert {s for s in one if s.startswith("gelu(")} \
        == {f"gelu{(N, T, D_FF)}"}
    # the attention probabilities: H / M heads
    assert {s for s in tp if s.startswith("_softmax(")} \
        == {f"_softmax{(N, half, T, T)}"}
    assert {s for s in one if s.startswith("_softmax(")} \
        == {f"_softmax{(N, HEADS, T, T)}"}


def test_megatron_refuses_context_and_expert_parallelism(four_ranks):
    _, ranks = four_ranks
    context, expert = ranks[0]["refuse/errors"]
    assert "Context parallelism and Megatron" in context
    assert "Expert parallelism and Megatron" in expert
