"""Whole runs of the harness on the CPU at tiny sizes: a cell, a
configuration and a per-layer metric added as files and entries alone are
found by name; and faults planted under the timed path make ``correct``
false."""

from __future__ import annotations

import json

import pytest

from hfbench import harness

from .conftest import edit_json

SEED = 2**31 + 12345  # above 32 signed bits, as the check's seeds may be


def test_a_cell_added_as_files_is_found(tiny_root):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = tiny_root / "hfbench" / "configs" / "lm-one-layer.json"
    cfg.write_text((tiny_root / "hfbench" / "configs"
                    / "gpt2-small.json").read_text())
    edit_json(cfg, name="lm-one-layer", model=dict(n_layers=1))
    bench["configs"].append(dict(name="lm-one-layer", source="a test",
                                 file="hfbench/configs/lm-one-layer.json",
                                 reduced=[], why="a test"))
    cell = tiny_root / "hfbench" / "cells" / "lm_b2.json"
    cell.write_text((tiny_root / "hfbench" / "cells"
                     / "gpt2s_step.json").read_text())
    edit_json(cell, batch=2, check_steps=1)
    bench["workloads"].append(dict(name="lm_b2", config="lm-one-layer",
                                   traffic="lm_b2", chips=1, why="a test"))
    (tiny_root / "hfbench" / "metrics" / "rows_per_step.py").write_text(
        "def read(run):\n    return 2.0\n")
    bench["per_layer"].append(dict(
        name="rows_per_step", unit="rows", better="higher",
        source="program_counter", layer="data", moves="step_s",
        workloads=["lm_b2"]))
    for m in bench["end_to_end"]:
        if m["name"] == "step_s":
            m["workloads"].append("lm_b2")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    result, compared = harness.run("lm_b2", SEED, 0.2, True, root=tiny_root,
                                   device="cpu")
    assert result["metrics"]["rows_per_step"]["value"] == 2.0
    assert "build_ms" not in result["metrics"]  # not this cell's metric
    assert set(compared) == {"loss", "grad", "update", "state"}
    assert set(result["info"]["read"]) == {"select"}  # its limit is null
    result, _ = harness.run("lm_b2", SEED, 0.2, False, root=tiny_root,
                            device="cpu")
    assert set(result["metrics"]) == {"step_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", ["gpt2s_step", "allcnnc_acc"])
def test_the_same_seed_makes_the_same_run(tiny_root, cell):
    a = harness.run(cell, SEED, 0.1, False, root=tiny_root, device="cpu")[1]
    b = harness.run(cell, SEED, 0.1, False, root=tiny_root, device="cpu")[1]
    assert a == b


# the altered choice is caught by ``select``, which GPT-2's cell reads
# without comparing (PERF.md)
@pytest.mark.parametrize("cell,fault", [
    ("gpt2s_step", "frozen"), ("gpt2s_step", "half_batch"),
    ("allcnnc_acc", "frozen"), ("allcnnc_acc", "half_batch"),
    ("allcnnc_acc", "choice")])
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    sound = harness.run(cell, SEED, 0.1, False, root=tiny_root,
                        device="cpu")[1]
    result, broken = harness.run(cell, SEED, 0.1, False, root=tiny_root,
                                 device="cpu", fault=fault)
    assert result["correct"] is False
    # the fault reads far above the sound run on some number
    assert any(broken[k][0] > 100 * max(sound[k][0], 1e-6) for k in sound)
    if fault == "frozen":
        assert broken["update"][0] == 1.0


def test_the_limits_fail_the_faults_and_pass_the_sound_run(tiny_root):
    """With limits at a tiny CPU run's scale, the sound run is correct and
    each fault is not."""
    edit_json(tiny_root / "hfbench" / "cells" / "allcnnc_acc.json",
              limits=dict(loss=1e-4, grad=1e-4, select=1e-4, update=0.05,
                          state=0.05, precond=1e-4))
    ok = harness.run("allcnnc_acc", SEED, 0.1, False, root=tiny_root,
                     device="cpu")[0]
    assert ok["correct"] is True
    for fault in ("frozen", "half_batch", "choice"):
        bad = harness.run("allcnnc_acc", SEED, 0.1, False, root=tiny_root,
                          device="cpu", fault=fault)[0]
        assert bad["correct"] is False


def test_traced_layers_fit_in_the_window(tiny_root):
    """The per-step layer times of a traced run add up to no more than
    the window: spans of the set-up's steps are not read."""
    result, _ = harness.run("allcnnc_acc", SEED, 0.5, True, root=tiny_root,
                            device="cpu")
    m = {k: v["value"] for k, v in result["metrics"].items()}
    per_step = (m["precond_ms"] + m["select_ms.acc"]) / 1e3
    window = result["device"]["window_s"]
    assert per_step * result["attempted"] <= window
    assert 0 <= m["device_idle_pct.acc"] <= 100
