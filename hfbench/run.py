#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 hfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Lines before the last on standard output
name the card (``torch.cuda.get_device_name``, the device count, and
``nvidia-smi``'s clocks and power limit); the last is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (with
``--trace 1`` also ``breakdown``), and last of all ``compared``, each number
that decided ``correct`` beside its limit.  Those numbers are also the last
lines on standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones.

The run fails, with no result line, where there is no CUDA card or fewer
cards than the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``pytorchhessianfree_tpu`` is loaded once the window has
closed.

``--control tf32`` runs the program with TF32 on (the lower precision that
the comparison has to refuse) and ``--fault <name>`` plants a fault under
the timed path (``faults.py``); neither is part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorchhessianfree_tpu")


def _caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / ".hfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def _card(torch, chips: int) -> str:
    if not torch.cuda.is_available():
        raise SystemExit("hfbench: no CUDA device; the benchmark runs only "
                         "on the card")
    count = torch.cuda.device_count()
    if count < chips:
        raise SystemExit(f"hfbench: the cell asks for {chips} cards, "
                         f"{count} present")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "clocks.mem,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"not read ({e})"
    return (f"card: {torch.cuda.get_device_name(0)}; devices: {count}; "
            f"nvidia-smi (name, sm clock, max sm clock, memory clock, "
            f"power draw, power limit, temperature): {smi}")


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32",))
    p.add_argument("--fault")
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from hfbench import harness, manifest

    started = harness.process_start()
    _caches()
    workload = manifest.entry(manifest.load(ROOT)["workloads"],
                              args.workload, "workload")
    import torch

    torch.set_num_threads(4)
    print(_card(torch, workload["chips"]), flush=True)
    result, compared = harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace),
        control=args.control, fault=args.fault, started=started)

    found = loaded_forbidden()
    if found:
        print(f"hfbench: {', '.join(found)} loaded in the run's process",
              file=sys.stderr)
        return 3
    info = result.pop("info")
    print("run: " + json.dumps(info), flush=True)
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["compared"] = {name: dict(value=value, limit=limit)
                          for name, (value, limit) in compared.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
