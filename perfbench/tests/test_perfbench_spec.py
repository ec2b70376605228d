"""BENCHMARK.json against the contract's form, and every name in it
resolved to its files."""

from __future__ import annotations

import re

import pytest

from perfbench.lib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (spec.BENCH_DIR / "configs" / f"{cfg['builder']}.py").is_file()
        assert (spec.BENCH_DIR / "reference"
                / f"{cfg['builder']}.py").is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.cell(cell)
    w = c["workload"]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert (spec.BENCH_DIR / "drivers"
            / f"{c['traffic']['driver']}.py").is_file()
    e2e = [m["name"] for m in c["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    assert c["limits"]["checks"]


def test_metrics():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        mod = spec.load_module("metrics", m["name"])
        assert (mod.SOURCE, mod.LAYER, mod.MOVES) == (
            m["source"], m["layer"], m["moves"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])
