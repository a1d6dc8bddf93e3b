"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name) or ".." in name:
        raise ValueError(f"not a name: {name!r}")
    return name


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load(root: Path = ROOT) -> dict:
    return read_json(Path(root) / "BENCHMARK.json")


def entry(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries")
    return found[0]


class Cell:
    """One workload of the manifest with everything it names: the
    configuration file, the traffic file (``cells/<traffic>.json``), the
    family's program side and reference, the entry, and the per-layer and
    end-to-end metrics that the cell reports."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = root = Path(root)
        self.manifest = load(root)
        self.workload = entry(self.manifest["workloads"], check_name(name),
                              "workload")
        cfg = entry(self.manifest["configs"],
                    check_name(self.workload["config"]), "config")
        self.config = read_json(root / cfg["file"])
        self.traffic = read_json(root / "hfbench" / "cells"
                                 / f"{check_name(self.workload['traffic'])}"
                                   ".json")
        family = check_name(self.config["family"])
        self.family = module(root, "families", family)
        self.reference = module(root, "reference", family)
        self.entry = module(root, "entries",
                            check_name(self.traffic["entry"]))
        self.end_to_end = [m for m in self.manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if name in m.get("workloads", [name])]

    def metric(self, name: str):
        """The reader of the per-layer metric ``name``: the quantity before
        the first dot (``select_ms.step`` and ``select_ms.acc`` are one
        reader's readings in cells that move different end-to-end
        metrics)."""
        return module(self.root, "metrics", check_name(name).split(".")[0])


def module(root: Path, kind: str, name: str):
    """``hfbench/<kind>/<name>.py`` under ``root``, loaded by its path as
    ``hfbench.<kind>.<name>``."""
    qualified = f"hfbench.{kind}.{name.replace('-', '_')}"
    path = Path(root) / "hfbench" / kind / f"{name}.py"
    if qualified in sys.modules and Path(
            sys.modules[qualified].__file__).resolve() == path.resolve():
        return sys.modules[qualified]
    spec = importlib.util.spec_from_file_location(qualified, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualified] = mod
    spec.loader.exec_module(mod)
    return mod
