"""The port's benchmark: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and metrics by the names in
``BENCHMARK.json`` (``lib/spec.py``), makes the weights and inputs on the
card from the seed, warms the cell's shapes, measures for ``--seconds``,
checks what the timed path produced against the plain reference, and
prints one JSON line. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, read from a profiler trace over a
short steady stretch of the window and from the program's counters.

The run needs a CUDA card (it exits 2 without one) and the port's sources
under ``src/`` beside this folder. It imports neither JAX nor the JAX
package, and refuses to print a result if anything loaded them.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, one
    thread for the host's math libraries (the load is one process; their
    spinning thread pools would take the cores the program's transfer
    workers wait on), and the import paths of this folder's package and
    of the port."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    cache = ROOT / "build" / "perfbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """One run's parameters and everything named for its cell."""

    def __init__(self, workload: str, seed: int, seconds: float,
                 trace: bool, device, smoke: bool = False):
        from perfbench.lib import spec

        self.name = workload
        self.cell = spec.cell(workload)
        self.config = dict(self.cell["config"])
        self.traffic = dict(self.cell["traffic"])
        if smoke:  # the CPU tests' sizes
            self.config.update(self.config.get("smoke", {}))
            self.traffic.update(self.traffic.get("smoke", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.limits = self.cell["limits"]["checks"]


def power_limit_w() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(run: Run, t_start: float) -> dict:
    """Set-up, the window, the reading of the trace and the check; returns
    the result line as a dict (``checks`` last)."""
    import torch

    from perfbench.lib import spec

    cuda = torch.device(run.device).type == "cuda"
    driver = spec.load_module("drivers", run.traffic["driver"])
    t_setup = time.perf_counter()
    st = driver.setup(run)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"perfbench: set-up {setup_s:.3f} s, of which before the "
          f"driver's {t_setup - t_start:.3f} s; "
          + ", ".join(f"{k} {v:.3f} s"
                      for k, v in getattr(st, "phases", {}).items()),
          file=sys.stderr)
    r = driver.window(run, st)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sub = r.pop("sub", None)
    trace = sub.read() if sub is not None else None
    driver.release(st)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check(run, st, r)

    r["setup_s"] = setup_s
    metrics = {}
    if not run.trace:
        for m in run.cell["end_to_end"]:
            if m["name"] in r:
                metrics[m["name"]] = {"value": r[m["name"]],
                                      "unit": m["unit"]}
            elif cuda:  # only a run on the card reads the device's trace
                raise KeyError(f"the run read no {m['name']}")
    else:
        ctx = dict(r, trace=trace, config=run.config, traffic=run.traffic)
        for m in run.cell["per_layer"]:
            value = spec.load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(0) if cuda
                       else "cpu"),
              "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
        if cuda:
            device["power_limit_w"] = power_limit_w()

    limits = {k: v["limit"] for k, v in run.limits.items()}
    if set(checks) != set(limits):
        raise KeyError(f"checks {sorted(checks)} but limits "
                       f"{sorted(limits)}")
    correct = all(math.isfinite(checks[k]) and checks[k] <= limits[k]
                  for k in checks)
    out = {"correct": correct, "attempted": r["attempted"],
           "failed": r.get("failed", 0), "metrics": metrics,
           "device": device}
    if trace is not None:
        out["breakdown"] = trace.breakdown()
    out["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                     for k in sorted(checks)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_environment()

    import torch

    from perfbench.lib import spec

    chips = spec.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    out = execute(run, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
