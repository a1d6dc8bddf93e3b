"""The port's examples (``examples_torch/``): the CPU-sized ones run end to
end with ``--cpu --tiny``, each in its own process with its own timeout,
``run_allcnnc_cifar100.py --dp``, ``run_sharded.py --tp`` and ``--megatron``,
``run_context_parallel.py`` and ``run_moe_lm.py --ep`` on two gloo ranks
and ``run_pipeline_parallel.py`` on four under ``torch.distributed.run``;
every example imports with ``jax`` blocked; without ``--cpu`` an example
needs the card and stops without one."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
TIMEOUT = 300  # seconds per example

# example -> the line that says it succeeded
CPU_RUNS = {
    "run_mwe": "loss decreased; done.",
    "run_rosenbrock": "converged.",
    "run_small_nn": "state_dict:",
    "run_small_nn_acc": "reduction self-test passed",
    "run_prefetch_loader": "loss decreased on loader batches; done.",
    "run_module_interop": "loss decreased; BatchNorm statistics tracked; done.",
}


# the data-parallel example, as torch.distributed.run starts it
LAUNCH = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
          "2"]
DP_RUN = LAUNCH + ["run_allcnnc_cifar100.py", "--dp", "--cpu", "--tiny"]
# the model-axis examples on two ranks -> the line that says they succeeded
MODEL_AXIS_RUNS = {
    "run_sharded": (["--tp"], "done."),
    "run_context_parallel": ([], "next-token loss halved under sequence "
                                 "splitting; done."),
    "run_moe_lm": (["--ep", "--tiny"], "next-token loss down through "
                                       "routed experts; done."),
}

# Megatron tensor parallelism on two ranks
MEGATRON_RUN = LAUNCH + ["run_sharded.py", "--cpu", "--megatron"]
MEGATRON_DONE = ("each rank computes 2 of 4 heads and 32 of 64 "
                 "feed-forward columns per block")

# the pipeline example: four ranks, one per stage
PIPELINE_RUN = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "4", "run_pipeline_parallel.py", "--cpu"]
PIPELINE_DONE = "next-token loss halved through the pipelined model; done."


@pytest.fixture(scope="module")
def started():
    """Every CPU example, started at once with one thread each, so that the
    file waits for the slowest example and not for their sum."""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    runs = {name: [str(EXAMPLES / f"{name}.py"), "--cpu", "--tiny"]
            for name in CPU_RUNS}
    runs["dp"] = DP_RUN
    for name, (flags, _) in MODEL_AXIS_RUNS.items():
        runs[f"2x-{name}"] = LAUNCH + [f"{name}.py", "--cpu", *flags]
    runs["megatron"] = MEGATRON_RUN
    runs["pipeline"] = PIPELINE_RUN
    procs = {
        name: subprocess.Popen(
            [sys.executable, *args], cwd=EXAMPLES, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for name, args in runs.items()
    }
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.mark.parametrize("name", sorted(CPU_RUNS))
def test_cpu_example_runs(started, name):
    proc = started[name]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"{name} did not finish within {TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    assert "on cpu" in out.splitlines()[0], out[:200]
    assert CPU_RUNS[name] in out, out[-2000:]


def test_cpu_data_parallel_example_runs(started):
    """``run_allcnnc_cifar100.py --dp --cpu --tiny`` on two gloo ranks:
    exit 0, rank 0's two steps with finite, falling losses."""
    proc = started["dp"]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the --dp example did not finish within {TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    assert "on cpu, 2 data-parallel ranks" in out, out[:300]
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == 2, out[-2000:]
    for line in steps:
        before, after = (float(v) for v in
                         line.split("loss ")[1].split(" |")[0].split(" -> "))
        assert after <= before and np.isfinite(after), line


@pytest.mark.parametrize("name", sorted(MODEL_AXIS_RUNS))
def test_cpu_model_axis_example_runs(started, name):
    """The model-axis examples on two gloo ranks: exit 0, and only rank 0
    prints, so each step appears once."""
    proc = started[f"2x-{name}"]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"{name} did not finish within {TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    assert MODEL_AXIS_RUNS[name][1] in out, out[-2000:]
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert steps and len(steps) == len(set(steps)), out[-2000:]
    assert out.count(MODEL_AXIS_RUNS[name][1]) == 1


def test_cpu_megatron_example_runs(started):
    """``run_sharded.py --cpu --megatron`` on two gloo ranks: exit 0, four
    steps with finite losses printed once (rank 0), the blocks' share."""
    proc = started["megatron"]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the --megatron example did not finish within "
                    f"{TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    assert out.count(MEGATRON_DONE) == 1 and out.count("done.") == 1, \
        out[-2000:]
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == len(set(steps)) == 4, out[-2000:]
    for line in steps:
        before, after = (float(v) for v in
                         line.split("loss ")[1].split(" |")[0].split(" -> "))
        assert after <= before and np.isfinite(after), line


def test_cpu_pipeline_example_runs(started):
    """``run_pipeline_parallel.py --cpu`` on four gloo ranks: exit 0, its
    six steps printed once (rank 0) and the loss halved."""
    proc = started["pipeline"]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        pytest.fail(f"the pipeline example did not finish within {TIMEOUT} s")
    assert proc.returncode == 0, err[-3000:]
    assert out.count(PIPELINE_DONE) == 1, out[-2000:]
    assert out.rstrip().splitlines()[-1] == PIPELINE_DONE
    steps = [line for line in out.splitlines() if line.startswith("step ")]
    assert len(steps) == len(set(steps)) == 6, out[-2000:]


_IMPORT_ALL = """
import importlib, runpy, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, {examples!r})
names = {names!r}
for name in names:
    importlib.import_module(name)
assert not any(m == "pytorchhessianfree_tpu"
               or m.startswith("pytorchhessianfree_tpu.") for m in sys.modules)
for script, flag in (("run_moe_lm", "--ep"),):
    sys.argv = [script, "--cpu", flag]
    try:
        runpy.run_path({examples!r} + "/" + script + ".py",
                       run_name="__main__")
    except SystemExit as e:
        assert "torch.distributed.run" in str(e), e
    else:
        raise AssertionError(script + " " + flag + " did not stop")
print(len(names))
"""


def test_every_example_imports_without_jax():
    """Every port example imports without JAX and without the JAX package
    (their work runs under ``__main__``), and a parallel flag outside a
    launcher (``run_moe_lm.py --ep``) stops with how to start the ranks."""
    names = sorted(p.stem for p in EXAMPLES.glob("*.py"))
    assert {"example_utils", "run_resnet18_mnist", "run_allcnnc_cifar100",
            "run_pipeline", "run_transformer", "run_decoder_lm",
            "run_moe_lm", "run_nystrom", "run_spectrum",
            "run_train_loop", "run_pipeline_parallel"} | set(CPU_RUNS) \
        | set(MODEL_AXIS_RUNS) \
        <= set(names)
    program = _IMPORT_ALL.format(examples=str(EXAMPLES), names=names)
    proc = subprocess.run([sys.executable, "-c", program], cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == len(names)


def test_examples_need_the_card_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(EXAMPLES / "run_mwe.py")],
                          cwd=EXAMPLES, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "--cpu" in proc.stderr and "loss" not in proc.stdout


@pytest.mark.cuda
def test_flagship_example_runs_on_the_card():
    """``run_resnet18_mnist.py --tiny`` on the card: the determinism
    self-test all true and the kernel launched once per CG iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the kernel")
    proc = subprocess.run(
        [sys.executable, str(EXAMPLES / "run_resnet18_mnist.py"), "--tiny"],
        cwd=EXAMPLES, capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "on cuda" in out and "False" not in out.split(
        "determinism self-test:")[1].splitlines()[0]
    launches = out.split("fused_cg_update launches: ")[1].split()[0]
    iters = out.split("(CG iterations ")[1].split(")")[0]
    assert int(launches) == sum(int(i) for i in iters.strip("[]").split(","))
