"""CLI for the concurrency analyzer: ``python -m repro_torch.analysis``.

Exit codes: 0 clean (or only baselined/waived findings with --fail-on-new),
1 findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .baseline import load_baseline, split_new, write_baseline
from .model import PackageModel, extract_module, extract_package
from .rules import RULES, Finding, run_rules


def analyze_source(source: str, modname: str = "snippet",
                   rules=RULES) -> list[Finding]:
    """Run the rules over a single in-memory module (test fixtures)."""
    pkg = PackageModel()
    pkg.modules[modname] = extract_module(source, modname)
    return run_rules(pkg, rules)


def _default_root() -> Path:
    # .../src/repro_torch/analysis/cli.py -> .../src
    return Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Concurrency static analysis for the repro_torch transfer stack")
    ap.add_argument("root", nargs="?", default=None,
                    help="directory containing the repro_torch package "
                         "(default: the installed src/ tree)")
    ap.add_argument("--rules", default=",".join(RULES),
                    help=f"comma-separated subset of: {', '.join(RULES)}")
    ap.add_argument("--baseline", default=None,
                    help="baseline JSON of grandfathered fingerprints")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="fail only on findings not in --baseline")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current findings as the new baseline and exit 0")
    ap.add_argument("--show-waived", action="store_true",
                    help="also list findings suppressed by # lock-ok waivers")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    rules = tuple(r.strip() for r in args.rules.split(",") if r.strip())
    bad = [r for r in rules if r not in RULES]
    if bad:
        ap.error(f"unknown rule(s): {', '.join(bad)} (want subset of {', '.join(RULES)})")

    root = Path(args.root) if args.root else _default_root()
    if not (root / "repro_torch").is_dir():
        ap.error(f"{root} does not contain a repro_torch/ package")

    pkg = extract_package(root)
    findings = run_rules(pkg, rules)
    active = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]

    if args.write_baseline:
        write_baseline(args.write_baseline, findings)
        print(f"wrote {len(active)} fingerprint(s) to {args.write_baseline}")
        return 0

    baseline = load_baseline(args.baseline) if args.baseline else set()
    if args.fail_on_new:
        new, old = split_new(findings, baseline)
    else:
        new, old = active, []

    if not args.quiet:
        for f in new:
            print(f.render())
        if old:
            print(f"note: {len(old)} baselined finding(s) suppressed")
        if args.show_waived:
            for f in waived:
                print(f.render() + (f" [{f.waiver}]" if f.waiver else ""))
        n_mod = len(pkg.modules)
        n_skip = sum(1 for m in pkg.modules.values() if m.skipped)
        n_locks = sum(len(c.locks) for c in pkg.all_classes()) + sum(
            len(m.module_locks) for m in pkg.modules.values())
        print(f"analysis: {n_mod} modules ({n_skip} skipped), {n_locks} lock "
              f"classes, {len(new)} new / {len(old)} baselined / "
              f"{len(waived)} waived finding(s)")
    return 1 if new else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
