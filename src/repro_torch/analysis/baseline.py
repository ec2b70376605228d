"""Baseline (grandfathered-findings) support.

Fingerprints are line-number free (rule:module:context:key), so moving code
around does not churn the baseline — only genuinely new violations fail
``--fail-on-new``. The checked-in baseline should stay empty: deliberate
sites get inline ``# lock-ok:`` waivers instead, so the reason lives next to
the code. The baseline exists for incremental adoption (e.g. annotating a
new module with pre-existing debt).
"""
from __future__ import annotations

import json
from pathlib import Path

from .rules import Finding

_VERSION = 1


def load_baseline(path: str | Path) -> set[str]:
    data = json.loads(Path(path).read_text())
    if data.get("version") != _VERSION:
        raise ValueError(f"unsupported baseline version {data.get('version')!r}")
    return set(data.get("fingerprints", []))


def write_baseline(path: str | Path, findings: list[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings if not f.waived})
    Path(path).write_text(json.dumps(
        {"version": _VERSION, "fingerprints": fps}, indent=2) + "\n")


def split_new(findings: list[Finding], baseline: set[str]):
    """(new, grandfathered) — waived findings are never 'new'."""
    new, old = [], []
    for f in findings:
        if f.waived:
            continue
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
