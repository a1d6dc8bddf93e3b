"""What the benchmark's sources import, by whole top-level module name:
nothing under ``hfbench/`` imports JAX or the JAX package, and the plain
references import nothing of the program either.  (The port's name begins
with the JAX package's, so names are compared whole, never as prefixes.)
A run checks ``sys.modules`` itself once its window has closed."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from hfbench import manifest

JAX = {"jax", "jaxlib", "flax", "pytorchhessianfree_tpu"}
PROGRAM = {"pytorchhessianfree_tpu_torch"}
SOURCES = sorted(manifest.HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(manifest.HERE))
                              for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((manifest.HERE / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (JAX | PROGRAM)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level:
            # only the references' own modules, beside it
            names = ([node.module] if node.module
                     else [a.name for a in node.names])
            assert node.level == 1 and set(names) <= {
                "hf", "tree", "problem"}, ast.dump(node)


def test_a_run_loads_no_jax(tiny_root):
    """The harness, the port and a CPU run of a cell leave no JAX module
    in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from hfbench import harness\n"
        "harness.run('gpt2s_step', 7, 0.1, False, root=%r, device='cpu')\n"
        "found = {m.split('.')[0] for m in sys.modules} & %r\n"
        "assert not found, found\n"
    ) % (str(manifest.ROOT), str(tiny_root), JAX)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=600)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result
    line."""
    proc = subprocess.run(
        [sys.executable, "hfbench/run.py", "--workload", "gpt2s_step",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
