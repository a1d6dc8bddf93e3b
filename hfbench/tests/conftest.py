"""Fixtures of the benchmark's own tests: a copy of the benchmark with its
configurations cut to sizes a CPU runs in seconds, and the card check of
the tests marked ``cuda``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODELS = {
    "gpt2-small": dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                       max_len=16),
    "allcnnc-cifar100": dict(size=12, channels=[8, 8, 8, 16, 16, 16, 16, 16,
                                                10]),
}
TINY_TRAFFIC = {
    "gpt2s_step": dict(seq_len=16, batches=3),
    "allcnnc_acc": dict(chunk=8, batches=3),
}


def edit_json(path: Path, **changes):
    data = json.loads(path.read_text())
    for key, value in changes.items():
        if isinstance(value, dict):
            data[key].update(value)
        else:
            data[key] = value
    path.write_text(json.dumps(data, indent=1))


def copy_benchmark(dest: Path, tiny: bool = True) -> Path:
    """``BENCHMARK.json`` and ``hfbench/`` under ``dest``; with ``tiny`` the
    models and traffic cut to :data:`TINY_MODELS` and
    :data:`TINY_TRAFFIC`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "hfbench", dest / "hfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if tiny:
        manifest = json.loads((dest / "BENCHMARK.json").read_text())
        for cfg in manifest["configs"]:
            edit_json(dest / cfg["file"], model=TINY_MODELS[cfg["name"]])
        for cell, changes in TINY_TRAFFIC.items():
            edit_json(dest / "hfbench" / "cells" / f"{cell}.json", **changes)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_benchmark(tmp_path)


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch
