"""The port never imports JAX: it imports with ``jax`` blocked."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROGRAM = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import pytorchhessianfree_tpu_torch as pkg
import pytorchhessianfree_tpu_torch.convert
import pytorchhessianfree_tpu_torch.models
import pytorchhessianfree_tpu_torch._build
assert "pytorchhessianfree_tpu" not in sys.modules
print(len(pkg.__all__))
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) > 0


def test_chip_smoke_imports_without_jax():
    program = _PROGRAM.replace(
        "import pytorchhessianfree_tpu_torch as pkg", "import chip_smoke as pkg"
    ).replace("len(pkg.__all__)", "1")
    proc = subprocess.run(
        [sys.executable, "-c", program], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
