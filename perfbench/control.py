"""The control of a cell's comparison, read at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--seconds S]

For each seed, the reference put in the program's place and computed at
the precision below the one the configuration states, compared as a run
compares the program (the driver's ``control``). The benchmark's runs do
not run it; its readings set the upper end of each limit
(``limits/<cell>.json``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.run import Run, set_environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the short window a served cell's control reads "
                         "(default: the benchmark's run_seconds)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from perfbench.lib import spec

    if args.device == "cuda" and not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or spec.benchmark()["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        run = Run(args.workload, seed, seconds, False,
                  torch.device(args.device), smoke=args.device == "cpu")
        driver = spec.load_module("drivers", run.traffic["driver"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": driver.control(run)}), flush=True)
        gc.collect()  # the seed's weights and caches, before the next's
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
