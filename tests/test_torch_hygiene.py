"""The port stands alone: it imports neither jax nor the reference package,
and its copied concurrency annotations pass the reference's analyzer."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.model import extract_package
from repro.analysis.rules import run_rules

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
SLICE_MODULES = [
    "repro_torch", "repro_torch.analysis.validated", "repro_torch.core",
    "repro_torch.core.runtime", "repro_torch.core.qos",
    "repro_torch.core.transfer", "repro_torch.core.cost_model",
    "repro_torch.core.streaming", "repro_torch.kernels._build",
    "repro_torch.kernels.conv2d", "repro_torch.kernels.conv2d.kernel",
    "repro_torch.kernels.conv2d.ref", "repro_torch.kernels.streamed_matmul",
    "repro_torch.kernels.streamed_matmul.kernel",
    "repro_torch.kernels.streamed_matmul.ref", "repro_torch.accel",
    "repro_torch.accel.roshambo", "repro_torch.accel.nullhop",
    "repro_torch.configs.roshambo",
]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [n for n in _imported_modules(path)
           if n == "jax" or n.startswith(("jax.", "jaxlib"))
           or n == "repro" or n.startswith("repro.")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_slice_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.') or m == 'repro'\n"
            "             or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_concurrency_analyzer_is_clean_on_the_port():
    """The reference's analyzer, unmodified, over the port's copies of the
    annotated modules: nothing to report against an empty baseline."""
    pkg = extract_package(ROOT / "src", package="repro_torch",
                          exclude=("repro_torch/analysis",))
    assert "repro_torch.core.transfer" in pkg.modules
    assert "repro_torch.core.runtime" in pkg.modules
    findings = [f for f in run_rules(pkg) if not f.waived]
    assert not findings, "\n".join(f.render() for f in findings)
    locks = sum(len(c.locks) for c in pkg.all_classes())
    assert locks > 0  # the annotations were seen, not skipped
