"""Nothing the benchmark runs on the card loads JAX or the JAX package,
and the references load nothing of the program. Top-level module names are
compared whole: ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import json
import subprocess
import sys

from perfbench.lib.spec import BENCH_DIR, ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from perfbench.lib import spec
for kind in {kinds!r}:
    for f in sorted((spec.BENCH_DIR / kind).glob("*.py")):
        if f.name != "__init__.py":
            spec.load_module(kind, f.stem)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(kinds, extra="") -> set[str]:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"), kinds=kinds,
                        extra=extra)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT), check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    extra = ("import runpy; runpy.run_path(str(spec.BENCH_DIR / 'run.py'))\n"
             "import repro_torch.accel.nullhop, "
             "repro_torch.serve.continuous, repro_torch.models.api")
    mods = _top_level(["configs", "drivers", "metrics", "reference",
                       "counts", "lib"], extra)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}, mods


def test_the_references_load_nothing_of_the_program():
    mods = _top_level(["reference"])
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, mods
    for f in (BENCH_DIR / "reference").glob("*.py"):
        text = f.read_text()
        assert "repro" not in text.replace("reproduc", ""), f
