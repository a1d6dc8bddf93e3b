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
  on the local tree and under the axes the step's plan picks for the
  Megatron specs (the blocks, and the embeddings, ``pos`` and the head
  split by feature or class; the rank's blocks of the gradient and the
  products gathered to compare) within 1e-10 of one process's: the encoder, the causal decoder
  LM with full and chunked attention, rematerialized blocks (the
  one-shot matvecs) and the MoE LM's attention; a head count the axis
  does not divide computes that sub-layer whole and gives the same
  values;
- what is split: a block's matmul FLOPs on a rank are half of one
  process's (``FlopCounterMode``), and so are the whole encoder's and
  the decoder LM's (its tied head contracting half the features), but
  for the tied head when the specs put ``embed`` and ``pos`` under
  ``P()``; a block's activations hold half the heads and half the
  feed-forward columns;
- where Megatron blocks meet the model axis's other roles: beside context
  parallelism the blocks are computed gathered and the sequence stays
  split (``mega_cp``: the decoder LM's Megatron specs with
  ``batch_specs=P(None, "model")``, no sum over the tensor axis); beside
  expert parallelism both partition, one replicated program (``mega_ep``:
  Megatron attention beside the MoE LM's expert specs, the loss adding
  the aux, the in-step empirical-Fisher diagonal; each rank computes its
  heads and its experts, with the attention's sums over the tensor
  axis); 1 step each at 1e-8 against the JAX package's step and the
  port's one-process step;
- the MoE LM with its rows split over the data axis (fault F5, repaired:
  the feed-forward routes every rank's rows together, as GSPMD does):
  ``ep_rows`` (EP, the loss adding the aux, the per-sample diagonals
  routing each sample alone) and ``mega_ep_rows`` (Megatron attention +
  EP with a loss summed over the rows, ``reduction="sum"``: the aux is
  each rank's share), 1 step each at 1e-8 against the JAX package's
  whole program and the port's one process; the draw drops choices by
  capacity;
- ``loop_tp_ema``: the Megatron encoder's train loop with the EMA
  empirical-Fisher diagonal (0.9), 1 step on a fixed 10-iteration solve
  at ``tp``'s first bound 2e-6, the diagonal at 1e-10, the blocks
  partitioned;
- inside the steps of ``wrap_tp``, ``loop_tp_ema``, ``ep_rows`` and
  ``mega_ep_rows`` (its attention's Megatron leaves and its experts) and
  of the derivative runs, each rank holds every partitioned leaf as its
  block: the model function receives the blocks,
  the local tree holds exactly their entries, and no op builds a whole
  flat vector.
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
    return parity.run_all(["wrap_tp", "mega", "split", "mega_cp", "mega_ep",
                           "ep_rows", "mega_ep_rows", "loop_tp_ema"],
                          tmp_path_factory.mktemp("sharded_megatron"), WORLD)


def test_wrapper_megatron_steps_match_jax_and_one_process(four_ranks):
    parity.check(four_ranks, "wrap_tp")
    _, ranks = four_ranks
    assert ranks[0]["wrap_tp/tp_sums"] > 0  # the blocks were partitioned
    # and the embeddings and the head: their gathers over the axis
    assert ranks[0]["wrap_tp/tp_gathers"] > 0


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
    # the partitioned step's model function took this rank's blocks and
    # no op built a whole flat vector
    seen = [eval(x) for x in holders[0][f"{key}/probe_shapes"]]
    assert len(seen) == 1 and int(holders[0][f"{key}/probe_flat"]) == 0
    whole = [tuple(t.shape) for t in worker.tree_flatten(
        worker.tiny_megatron_model(kind)[0])[0]]
    local = sum(int(np.prod(s)) for s in seen[0])
    assert local < sum(int(np.prod(s)) for s in whole)
    for got_shape, shape in zip(seen[0], whole):
        assert got_shape == shape or any(
            2 * g == w and got_shape[:i] + got_shape[i + 1:]
            == shape[:i] + shape[i + 1:]
            for i, (g, w) in enumerate(zip(got_shape, shape)))
    sums = int(holders[0][f"{key}/sums"])
    if kind == "odd":  # 3 heads and d_ff 33 over 2 ranks: no block split
        assert sums == 0
    else:  # heads1: the MLP alone is split; moe: the attention alone
        assert sums > 0
    # the embeddings (d 16, or 12 for odd) are split: their stream is
    # gathered over the axis
    assert int(holders[0][f"{key}/gathers"]) > 0


def test_a_rank_computes_half_of_a_block(four_ranks):
    _, ranks = four_ranks
    for r in ranks:
        tp, one = (int(r[f"split/{k}/block_flops"]) for k in ("tp", "one"))
        assert tp > 0 and 2 * tp == one
        # the embeddings and the head are split too: exactly half of the
        # encoder's forward and of the decoder LM's, whose tied head
        # contracts half the features
        for forward in ("forward_flops", "dec_forward_flops"):
            tp, one = (int(r[f"split/{k}/{forward}"]) for k in ("tp", "one"))
            assert tp > 0 and 2 * tp == one
        # with embed and pos under P() the spec keeps them whole, and so
        # the tied head: the blocks' half plus the whole [N, T, d] x [d, V]
        tp, one = (int(r[f"split/{k}/dec_whole_embed_flops"])
                   for k in ("tp", "one"))
        head = 2 * 4 * 8 * 16 * 12
        assert 2 * tp == one + head


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
    """No longer refused, and the steps match JAX and one process: beside
    context parallelism the Megatron blocks are computed gathered (no sum
    over the tensor axis); beside expert parallelism the attention is
    partitioned too (its sums over the tensor axis), the experts split."""
    _, ranks = four_ranks
    for case in ("mega_cp", "mega_ep"):
        parity.check(four_ranks, case)
        for r in ranks:
            if case == "mega_cp":
                assert r[f"{case}/tp_sums"] == r[f"{case}/tp_gathers"] == 0
            else:
                assert r[f"{case}/tp_sums"] > 0
        # the Megatron-specced weights are still kept as blocks
        assert "(16, 24)" in str(ranks[0][f"{case}/shapes"])


def test_moe_with_rows_split_over_data_matches_jax(four_ranks):
    """Fault F5: Megatron attention + EP with the rows split over the data
    axis (the default batch specs) and a loss summed over the rows,
    against the JAX package's whole program: the MoE routes every rank's
    rows together, and the aux counts once."""
    parity.check(four_ranks, "mega_ep_rows")


def test_expert_parallel_with_rows_split_matches_jax(four_ranks):
    """``ep_rows``: EP alone with the rows split, the in-step diagonal's
    per-sample gradients routing each sample alone, against the JAX
    package's whole program (``mega_ep``'s run)."""
    parity.check(four_ranks, "ep_rows")


@pytest.mark.parametrize("case", ["ep_rows", "mega_ep_rows"])
def test_row_split_moe_draws_drop_choices(four_ranks, case):
    """The capacity drops choices in one process's forward of the draw,
    so routing each rank's rows alone would not match."""
    refs, _ = four_ranks
    assert refs[case][1]["dropped"] > 0


def test_megatron_ema_loop_matches_jax_and_one_process(four_ranks):
    parity.check(four_ranks, "loop_tp_ema")
    _, ranks = four_ranks
    assert ranks[0]["loop_tp_ema/tp_sums"] > 0  # the blocks partitioned
    assert ranks[0]["loop_tp_ema/tp_gathers"] > 0  # embeddings and head


@pytest.mark.parametrize("case, partitioned", [
    ("wrap_tp", parity.tensor_split), ("loop_tp_ema", parity.tensor_split),
    ("ep_rows", parity.expert_split),
    ("mega_ep_rows", parity.tensor_split)])
def test_step_keeps_partitioned_leaves_as_blocks(four_ranks, case,
                                                 partitioned):
    """Inside the step each rank holds every partitioned leaf as its block
    (the Megatron leaves under the tensor axis; beside EP, the attention's
    Megatron leaves and the experts): the model function receives the
    blocks, the local tree holds exactly the whole tree's entries less the
    other rank's share of the partitioned leaves, and no op builds a whole
    flat vector."""
    parity.check_blocks(four_ranks, case, partitioned)
