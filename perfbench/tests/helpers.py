"""Runs a cell here on the CPU at its configuration's smoke sizes (the
``smoke`` groups of its configuration and traffic files), past the run's
look for a card."""

from __future__ import annotations

import sys
import time

from perfbench.lib.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))


def smoke_run(cell: str, seed: int = 2**31 + 7, seconds: float = 0.5):
    import torch

    from perfbench import run as bench_run

    return bench_run.Run(cell, seed, seconds, False, torch.device("cpu"),
                         smoke=True)


def execute(run) -> dict:
    from perfbench import run as bench_run

    return bench_run.execute(run, time.perf_counter())
