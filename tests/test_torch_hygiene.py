"""The port stands alone: it imports neither jax nor the reference package,
and its concurrency annotations pass its own analyzer (the reference's rules
plus the card's waits) and, kept in step, the reference's."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.model import extract_package as jextract_package
from repro.analysis.rules import run_rules as jrun_rules
from repro_torch.analysis.model import extract_package
from repro_torch.analysis.rules import run_rules

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
SLICE_MODULES = [
    "repro_torch", "repro_torch.device", "repro_torch.analysis.validated",
    "repro_torch.core",
    "repro_torch.core.runtime", "repro_torch.core.qos",
    "repro_torch.core.transfer", "repro_torch.core.cost_model",
    "repro_torch.core.streaming", "repro_torch.kernels._build",
    "repro_torch.kernels._split",
    "repro_torch.kernels.conv2d", "repro_torch.kernels.conv2d.kernel",
    "repro_torch.kernels.conv2d.ref", "repro_torch.kernels.streamed_matmul",
    "repro_torch.kernels.streamed_matmul.kernel",
    "repro_torch.kernels.streamed_matmul.ref", "repro_torch.accel",
    "repro_torch.accel.roshambo", "repro_torch.accel.nullhop",
    "repro_torch.configs.roshambo", "repro_torch.configs",
    "repro_torch.configs.registry", "repro_torch.configs.qwen2_5_3b",
    "repro_torch.configs.h2o_danube_1_8b", "repro_torch.configs.stablelm_12b",
    "repro_torch.configs.internlm2_20b", "repro_torch.models.config",
    "repro_torch.models.layers.norm", "repro_torch.models.layers.rope",
    "repro_torch.models.layers.mlp", "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.flash_attention.ref",
    "repro_torch.kernels.flash_attention.kernel",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.decode_attention",
    "repro_torch.kernels.decode_attention.ref",
    "repro_torch.kernels.decode_attention.kernel",
    "repro_torch.kernels.decode_attention.ops",
    "repro_torch.models.layers.attention", "repro_torch.models.layers.mla",
    "repro_torch.configs.deepseek_v2_lite", "repro_torch.kernels.kda",
    "repro_torch.kernels.kda.ref", "repro_torch.kernels.kda.kernel",
    "repro_torch.kernels.kda.ops", "repro_torch.models.layers.kda",
    "repro_torch.configs.kimi_linear_48b_a3b", "repro_torch.models.lm",
    "repro_torch.models.api", "repro_torch.serve", "repro_torch.serve.engine",
    "repro_torch.launch.serve", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.ssd_scan.ref", "repro_torch.kernels.ssd_scan.kernel",
    "repro_torch.kernels.ssd_scan.ops", "repro_torch.models.layers.ssm",
    "repro_torch.models.hybrid", "repro_torch.configs.mamba2_780m",
    "repro_torch.configs.zamba2_1_2b", "repro_torch.utils",
    "repro_torch.utils.timing", "repro_torch.utils.trace", "repro_torch.dist",
    "repro_torch.dist.fault",
    "repro_torch.core.faults", "repro_torch.core.channels",
    "repro_torch.core.adaptive", "repro_torch.models.layers.moe",
    "repro_torch.models.encdec", "repro_torch.serve.continuous",
    "repro_torch.examples", "repro_torch.examples.serve_lm",
    "repro_torch.configs.granite_moe_1b_a400m",
    "repro_torch.configs.deepseek_moe_16b",
    "repro_torch.configs.seamless_m4t_medium",
    "repro_torch.configs.pixtral_12b", "repro_torch.utils.pytree",
    "repro_torch.optim", "repro_torch.optim.schedule",
    "repro_torch.optim.adamw", "repro_torch.optim.compression",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
    "repro_torch.train", "repro_torch.train.loop",
    "repro_torch.launch.train", "repro_torch.examples.train_lm",
    "repro_torch.examples.quickstart", "repro_torch.dist.elastic",
    "repro_torch.dist.sharding", "repro_torch.launch.mesh",
    "repro_torch.core.pipeline_collectives",
    "repro_torch.examples.elastic_restart",
    "repro_torch.examples.transfer_modes", "repro_torch.launch.dryrun",
    "repro_torch.launch.op_cost", "repro_torch.launch.collective_cost",
    "repro_torch.launch.dryrun_compare", "repro_torch.analysis",
    "repro_torch.analysis.model", "repro_torch.analysis.rules",
    "repro_torch.analysis.cli", "repro_torch.analysis.baseline",
    "repro_torch.analysis.stress", "repro_torch.core.scheduler",
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
    code = ("import importlib, sys, warnings\n"
            "warnings.filterwarnings('ignore', category=DeprecationWarning,\n"
            "                        message='repro_torch.core.scheduler')\n"
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
    """The port's own analyzer (the card's waits in its blocking rule) over
    the port: nothing to report against an empty baseline."""
    pkg = extract_package(ROOT / "src")
    assert "repro_torch.core.transfer" in pkg.modules
    assert "repro_torch.core.runtime" in pkg.modules
    findings = [f for f in run_rules(pkg) if not f.waived]
    assert not findings, "\n".join(f.render() for f in findings)
    locks = sum(len(c.locks) for c in pkg.all_classes())
    assert locks > 0  # the annotations were seen, not skipped


def test_reference_analyzer_is_clean_on_the_port():
    """The reference's analyzer, unmodified, over the port, so the two stay
    in step: the port's annotations are the reference's."""
    pkg = jextract_package(ROOT / "src", package="repro_torch",
                           exclude=("repro_torch/analysis",))
    assert "repro_torch.core.runtime" in pkg.modules
    findings = [f for f in jrun_rules(pkg) if not f.waived]
    assert not findings, "\n".join(f.render() for f in findings)


def test_analyzer_cli_runs_without_jax_or_the_reference():
    """``python -m repro_torch.analysis`` over ``src`` against the checked-in
    baseline: exit 0, 0 new findings, and neither jax nor ``repro`` loaded
    (the card's machine has no jax)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['repro_torch.analysis', 'src', '--baseline',\n"
            "            'analysis_baseline.json', '--fail-on-new']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.') or m == 'repro'\n"
            "             or m.startswith('repro.'))\n"
            "print('rc', rc, 'loaded', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0, out.stderr
    assert lines[-1] == "rc 0 loaded []", out.stdout
    assert " 0 new / 0 baselined / " in lines[-2], out.stdout
