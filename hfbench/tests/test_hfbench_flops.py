"""Each family's FLOPs per forward, counted from shapes, against what
``torch.utils.flop_counter.FlopCounterMode`` counts in the port's forward
at small widths."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hfbench import manifest

CASES = [
    ("decoder_lm", dict(vocab=97, d_model=48, n_heads=4, n_layers=3, d_ff=80,
                        max_len=24, zipf_s=1.0), dict(seq_len=24), 3),
    ("decoder_lm", dict(vocab=50, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                        max_len=16, zipf_s=1.1), dict(seq_len=10), 2),
    ("allcnnc", dict(size=32, in_channels=3, kernels=[3] * 7 + [1, 1],
                     channels=[12, 12, 12, 24, 24, 24, 24, 24, 10],
                     strides=[1, 1, 2, 1, 1, 2, 1, 1, 1],
                     padding=["SAME"] * 6 + ["VALID", "SAME", "SAME"],
                     l2=5e-4), {}, 4),
    ("allcnnc", dict(size=12, in_channels=3, kernels=[3] * 7 + [1, 1],
                     channels=[8, 8, 8, 16, 16, 16, 16, 16, 10],
                     strides=[1, 1, 2, 1, 1, 2, 1, 1, 1],
                     padding=["SAME"] * 6 + ["VALID", "SAME", "SAME"],
                     l2=5e-4), {}, 2),
]


@pytest.mark.parametrize("family,model,traffic,rows", CASES)
def test_forward_flops_match_the_counter(family, model, traffic, rows):
    fam = manifest.module(manifest.ROOT, "families", family)
    gen = torch.Generator().manual_seed(0)
    params = fam.make_params(model, gen, "cpu")
    x, _ = fam.make_rows(model, traffic, rows, gen, "cpu")
    fns = fam.program_fns(model)
    counter = FlopCounterMode(display=False)
    with counter:
        fns["model_fn"](params, x)
    assert counter.get_total_flops() == fam.forward_flops(model, traffic,
                                                          rows)


@pytest.mark.parametrize("family,model,traffic,rows", CASES[::2])
def test_parameter_count_matches_the_tree(family, model, traffic, rows):
    fam = manifest.module(manifest.ROOT, "families", family)
    params = fam.make_params(model, torch.Generator().manual_seed(0), "cpu")
    from hfbench.reference.tree import leaves

    assert sum(t.numel() for _, t in leaves(params)) == \
        fam.parameter_count(model)


def test_published_configurations_count_their_parameters():
    data = manifest.load()
    for cfg in data["configs"]:
        config = manifest.read_json(manifest.ROOT / cfg["file"])
        fam = manifest.module(manifest.ROOT, "families", config["family"])
        assert fam.parameter_count(config["model"]) == config["parameters"]


def test_gpt2_forward_flops_at_the_cell():
    """1.1666 TFLOP for [4, 1024], the figure PERF.md's prediction uses."""
    data = manifest.load()
    cfg = [c for c in data["configs"] if c["name"] == "gpt2-small"][0]
    fam = manifest.module(manifest.ROOT, "families", "decoder_lm")
    model = manifest.read_json(manifest.ROOT / cfg["file"])["model"]
    assert fam.forward_flops(model, dict(seq_len=1024), 4) == 1166593228800
