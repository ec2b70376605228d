"""The port's dry run held against the reference's, cell by cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        --out build/dryrun.jsonl
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \
        --out build/ref_dryrun.jsonl
    PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun --all \
        --multi-pod --out build/ref_dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun_compare \
        build/dryrun.jsonl build/ref_dryrun.jsonl [--markdown]

Reads the two JSONL files (it imports nothing of the reference). For each
(arch, shape, mesh) it prints the port's FLOPs, collective bytes and peak
bytes a device beside the reference's FLOPs, collective bytes and memory
(argument + output + temp - alias of XLA's ``memory_analysis``) and their
ratios, then checks the cells against the limits below and exits 1 if one
fails:

- no cell of the port's ends in ``error``;
- every ``ok`` prefill_32k / decode_32k cell with a reference figure has
  FLOPs a device within ``FLOPS_RATIO`` of the reference's, either way;
- every ``ok`` long_500k cell with a reference figure has FLOPs a device
  at most ``FLOPS_RATIO`` times the reference's (an upper bound only: the
  reference's program there does more than the whole model's FLOPs for
  zamba2, a pass over the whole cache, which the port does not);
- every ``ok`` cell peaks under ``CARD_BYTES`` a device;
- the moe, ssm and hybrid families' prefill_32k / decode_32k cells peak
  within ``MEMORY_RATIO`` of the reference's memory;
- the ssm and hybrid families' decode_32k and long_500k cells move within
  ``COLLECTIVE_RATIO`` of the reference's collective bytes.

The reference's train cells end in its own ``ImportError``
(``batch_axis_size``), so they have no figure and are held to ``ok`` and
the peak bound only.
"""

from __future__ import annotations

import argparse
import json
import sys

FLOPS_RATIO = 1.10
CARD_BYTES = 80e9
MEMORY_RATIO = 3.0
COLLECTIVE_RATIO = 10.0
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(path: str) -> dict:
    """{(arch, shape, multi_pod): record} of a JSONL file (the last record
    of a cell wins, as a rerun appends)."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                out[(r["arch"], r["shape"], bool(r["multi_pod"]))] = r
    return out


def reference_memory(rec: dict) -> float:
    """argument + output + temp - alias bytes of a reference record."""
    m = rec.get("memory_analysis", {})
    return float(m.get("argument_size_in_bytes", 0)
                 + m.get("output_size_in_bytes", 0)
                 + m.get("temp_size_in_bytes", 0)
                 - m.get("alias_size_in_bytes", 0))


def compare(port: dict, ref: dict) -> tuple[list[dict], list[str]]:
    """One row a port cell (its figures, the reference's and the ratios)
    and the list of failed checks."""
    from repro_torch.configs.registry import get_config

    rows, failed = [], []
    for key in sorted(port, key=lambda k: (k[2], k[0], SHAPES.index(k[1])
                                           if k[1] in SHAPES else 9)):
        arch, shape, pod2 = key
        p, r = port[key], ref.get(key, {})
        row = {"arch": arch, "shape": shape, "multi_pod": pod2,
               "status": p["status"]}
        name = f"{arch} {shape} {'(2, 16, 16)' if pod2 else '(16, 16)'}"
        if p["status"] == "error":
            failed.append(f"{name}: error {p.get('error', '')[:100]}")
        if p["status"] != "ok":
            rows.append(row)
            continue
        row.update(flops=p["flops_per_device"],
                   collective=p["collective_bytes_per_device"],
                   peak=p["peak_bytes"])
        if r.get("status") == "ok":
            mem = reference_memory(r)
            row.update(ref_flops=r["flops_per_device"],
                       ref_collective=r["collective_bytes_per_device"],
                       ref_memory=mem,
                       flops_ratio=p["flops_per_device"]
                       / r["flops_per_device"],
                       collective_ratio=p["collective_bytes_per_device"]
                       / max(r["collective_bytes_per_device"], 1.0),
                       memory_ratio=p["peak_bytes"] / mem)
        rows.append(row)
        if row["peak"] >= CARD_BYTES:
            failed.append(f"{name}: peak {row['peak']:.4g} B a device")
        if "flops_ratio" not in row or shape not in SHAPES[1:]:
            continue
        both_ways = shape != "long_500k"
        if (row["flops_ratio"] > FLOPS_RATIO
                or both_ways and row["flops_ratio"] < 1 / FLOPS_RATIO):
            failed.append(f"{name}: FLOPs {row['flops_ratio']:.3f}x")
        family = get_config(arch).family
        if (family in ("moe", "ssm", "hybrid") and both_ways
                and row["memory_ratio"] > MEMORY_RATIO):
            failed.append(f"{name}: peak {row['memory_ratio']:.2f}x the "
                          "reference's memory")
        if (family in ("ssm", "hybrid")
                and shape in ("decode_32k", "long_500k")
                and row["collective_ratio"] > COLLECTIVE_RATIO):
            failed.append(f"{name}: collective bytes "
                          f"{row['collective_ratio']:.1f}x")
    return rows, failed


def _cell(row: dict) -> str:
    if row["status"] != "ok":
        return row["status"]
    text = f"{row['flops']:.3g} / {row['peak'] / 1e9:.3g} GB"
    if "flops_ratio" not in row:
        return text + " (no ref)"
    return (f"{row['flops']:.3g} ({row['flops_ratio']:.2f}) / "
            f"{row['peak'] / 1e9:.3g} GB ({row['memory_ratio']:.2f}) / "
            f"C {row['collective_ratio']:.2g}")


def markdown(rows: list[dict]) -> str:
    """A row an arch and mesh, a column a shape: FLOPs a device (port /
    reference), peak GB a device (port peak / reference memory),
    collective bytes (port / reference)."""
    table = {}
    for row in rows:
        key = (row["arch"], row["multi_pod"])
        table.setdefault(key, {})[row["shape"]] = _cell(row)
    lines = ["| arch, mesh | " + " | ".join(SHAPES) + " |",
             "| --- |" + " --- |" * len(SHAPES)]
    for (arch, pod2), cells in table.items():
        mesh = "(2, 16, 16)" if pod2 else "(16, 16)"
        lines.append(f"| {arch} {mesh} | " + " | ".join(
            cells.get(s, "") for s in SHAPES) + " |")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("port")
    ap.add_argument("reference")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows, failed = compare(load(args.port), load(args.reference))
    if args.markdown:
        print(markdown(rows))
    else:
        for row in rows:
            print(json.dumps(row))
    counts = {}
    for row in rows:
        counts[row["status"]] = counts.get(row["status"], 0) + 1
    print(json.dumps({"cells": counts, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
