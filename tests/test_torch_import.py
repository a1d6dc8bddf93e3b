"""The port never imports JAX: it imports with ``jax`` blocked."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

_PROGRAM = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import pytorchhessianfree_tpu_torch as pkg
import pytorchhessianfree_tpu_torch.convert
import pytorchhessianfree_tpu_torch.models
import pytorchhessianfree_tpu_torch.accumulate
import pytorchhessianfree_tpu_torch.ops.precond
import pytorchhessianfree_tpu_torch.models.allcnnc
import pytorchhessianfree_tpu_torch.models.targetfunc
import pytorchhessianfree_tpu_torch._build
import pytorchhessianfree_tpu_torch.models.transformer
import pytorchhessianfree_tpu_torch.models.moe
import pytorchhessianfree_tpu_torch.utils.remat
import pytorchhessianfree_tpu_torch.ops.nystrom
import pytorchhessianfree_tpu_torch.ops.spectrum
import pytorchhessianfree_tpu_torch.ops.select
import pytorchhessianfree_tpu_torch.checkpoint
import pytorchhessianfree_tpu_torch.interop
import pytorchhessianfree_tpu_torch.runtime
import pytorchhessianfree_tpu_torch.runtime.loader
import pytorchhessianfree_tpu_torch.runtime.prefetch
import pytorchhessianfree_tpu_torch.utils.memory
import pytorchhessianfree_tpu_torch.parallel
import pytorchhessianfree_tpu_torch.parallel.distributed
import pytorchhessianfree_tpu_torch.parallel.mesh
import pytorchhessianfree_tpu_torch.parallel.data_parallel
import pytorchhessianfree_tpu_torch.parallel.collectives
import pytorchhessianfree_tpu_torch.parallel.sharded
import pytorchhessianfree_tpu_torch.parallel.pipeline
sys.path.insert(0, "tests")
import _torch_dp_worker  # the data-parallel rank of the CPU tests
import _torch_collectives_worker  # the collectives' rank of the CPU tests
import _torch_sharded_worker  # the model-axis rank of the CPU tests
import _torch_pipeline_worker  # the pipeline's rank of the CPU tests
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


def test_checkpoint_names_after_every_import():
    """As in the JAX package, the package's ``checkpoint`` is the checkpoint
    module, whatever was imported before; the rematerializing wrapper stays
    ``utils.remat.checkpoint`` (and ``utils.checkpoint``)."""
    import importlib
    import pkgutil

    import pytorchhessianfree_tpu_torch as pkg

    for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(mod.name)
    from pytorchhessianfree_tpu_torch import checkpoint, utils
    from pytorchhessianfree_tpu_torch.utils import remat

    assert pkg.checkpoint is checkpoint
    assert checkpoint.__name__ == "pytorchhessianfree_tpu_torch.checkpoint"
    assert callable(pkg.checkpoint.save) and callable(pkg.checkpoint.restore)
    assert remat.checkpoint is utils.checkpoint
    assert remat.checkpoint.__module__ == remat.__name__
    twice = remat.checkpoint(lambda t: 2 * t)
    assert float(twice(torch.ones(()))) == 2.0


# the JAX package's flax/haiku adapters -> the port's nn.Module adapter
_SUBSTITUTED = {
    "split_flax_variables": "split_module_state",
    "flax_fns": "module_fns",
    "haiku_fns": "module_fns",
    "flax_state_update": "module_state_update",
    "haiku_state_update": "module_state_update",
}


def test_public_names_of_the_jax_package_are_exported():
    """Every name in the JAX package's ``__all__`` is in the port's, apart
    from the flax/haiku adapters, whose place the ``nn.Module`` adapter
    takes (``interop.py``)."""
    import pytorchhessianfree_tpu as jhf
    import pytorchhessianfree_tpu_torch as thf

    missing = set(jhf.__all__) - set(thf.__all__) - set(_SUBSTITUTED)
    assert not missing, sorted(missing)
    assert set(_SUBSTITUTED) <= set(jhf.__all__)
    assert set(_SUBSTITUTED.values()) <= set(thf.__all__)
    assert not set(_SUBSTITUTED) & set(thf.__all__)
    for name in thf.__all__:
        assert hasattr(thf, name), name
