"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the configuration as it is run; its
  ``"builder"`` names ``configs/<builder>.py``, which makes the weights on
  the device from the seed and builds the program's model object.
- ``traffic/<traffic>.json``: the traffic mix, parameters only; its
  ``"driver"`` names ``drivers/<driver>.py``, the general generator and loop.
- ``metrics/<metric>.py``: one reader per per-layer metric.
- ``reference/<builder>.py``: the plain reference of a configuration kind.
- ``limits/<cell>.json``: the limits the cell's comparison holds its
  numbers to, with the readings they were set from.

Modules are loaded from their files, so a later change adds a cell, a
configuration or a metric as new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(kind: str, name: str) -> ModuleType:
    """``perfbench/<kind>/<name>.py`` as a module (names may hold ``.``
    and ``-``, so it is loaded from its path)."""
    key = f"perfbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is not None:
        return mod
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: dict | None = None) -> dict:
    """Everything named for one cell: its entry, its configuration's entry
    and file, its traffic, its metrics and its limits."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[w["config"]]
    cfg = load_json(ROOT / centry["file"])

    def mine(m: dict) -> bool:
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config_entry": centry,
        "config": cfg,
        "traffic": load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
        "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
    }
