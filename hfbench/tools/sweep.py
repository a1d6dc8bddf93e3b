#!/usr/bin/env python3
"""Run one cell several times, one process after another, and sum up.

    python3 hfbench/tools/sweep.py --workload <name> --seeds 11,12,13 \
        --seconds 51 [--trace 0|1] [--control tf32] [--fault <name>] \
        [--out chiprun_out/<file>.jsonl]

Each run is ``hfbench/run.py`` in a process of its own, as the benchmark's
check runs it.  Every run's result line, exit code, wall time, the card
line and the end of its standard error go to ``--out`` (one JSON object per
line); a summary follows on standard output: per run its seed, ``correct``,
metrics and compared numbers, then per metric the median and the spread
(the distance between the first and third quartiles from
``statistics.quantiles(values, n=4)``, as a share of the median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--control")
    p.add_argument("--fault")
    p.add_argument("--out")
    p.add_argument("--timeout", type=float, default=900)
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    runs = []
    for seed in args.seeds.split(","):
        cmd = [sys.executable, "hfbench/run.py", "--workload", args.workload,
               "--seed", seed, "--seconds", args.seconds,
               "--trace", args.trace]
        if args.control:
            cmd += ["--control", args.control]
        if args.fault:
            cmd += ["--fault", args.fault]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=args.timeout)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.time() - t0
        lines = stdout.strip().splitlines()
        result = None
        if rc == 0 and lines:
            try:
                result = json.loads(lines[-1])
            except json.JSONDecodeError:
                pass
        rec = dict(workload=args.workload, seed=int(seed), rc=rc, wall_s=wall,
                   trace=args.trace, control=args.control, fault=args.fault,
                   preamble=lines[:-1] if result else lines[-20:],
                   stderr_tail=stderr[-3000:], result=result)
        runs.append(rec)
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        summary = {k: v["value"] for k, v in (result or {}).get(
            "metrics", {}).items()}
        compared = {k: v["value"] for k, v in (result or {}).get(
            "compared", {}).items()}
        info = [x for x in rec["preamble"] if x.startswith("run: ")]
        print(f"seed {seed} rc {rc} wall {wall:.1f} s correct "
              f"{(result or {}).get('correct')} metrics {summary} compared "
              f"{compared} {info[-1][5:] if info else ''}", flush=True)
        if rc != 0:
            print(stderr[-1500:], flush=True)
    metrics = {}
    for rec in runs:
        for k, v in ((rec["result"] or {}).get("metrics") or {}).items():
            metrics.setdefault(k, []).append(v["value"])
    for k, vals in metrics.items():
        s = spread(vals)
        print(f"{k}: n {len(vals)} median {statistics.median(vals)!r} "
              f"spread {s!r} values {vals}")
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
