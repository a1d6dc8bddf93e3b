"""The control on the card: the program computed in TF32, the precision
below the float32 that both configurations state, has to come out not
correct.  At a size a test run holds: the cells' widths, with fewer layers,
shorter sequences and smaller chunks; the limits are the cells' own.
Run on the card with ``python -m pytest -m cuda hfbench/tests``."""

from __future__ import annotations

import pytest

from hfbench import harness

from .conftest import copy_benchmark, edit_json

SMALLER = {
    "gpt2s_step": ("gpt2-small", dict(n_layers=2), dict(seq_len=256,
                                                        batches=2)),
    "allcnnc_acc": ("allcnnc-cifar100", {}, dict(chunk=64, batches=2)),
}


@pytest.fixture
def small_root(tmp_path):
    root = copy_benchmark(tmp_path, tiny=False)
    for cell, (config, model, traffic) in SMALLER.items():
        if model:
            edit_json(root / "hfbench" / "configs" / f"{config}.json",
                      model=model)
        edit_json(root / "hfbench" / "cells" / f"{cell}.json", **traffic)
    return root


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALLER))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_the_tf32_control_is_not_correct(card, small_root, cell, seed):
    result, compared = harness.run(cell, seed, 0.5, False, root=small_root,
                                   control="tf32")
    assert result["correct"] is False, compared
