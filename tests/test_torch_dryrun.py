"""The port's dry run (``launch/{dryrun,op_cost,collective_cost}.py`` and
``models/api.py:input_specs`` / ``cache_specs``) against the reference's on
the CPU:

- ``input_specs`` / ``cache_specs``: the reference's keys, shapes and dtypes
  for every arch and shape cell it applies to, with no storage;
- ``OpCost``'s FLOPs equal to ``repro.launch.hlo_cost.analyze``'s over the
  reference's compiled HLO, exactly, on a smoke forward (B 2 x S 64) of
  each family (dense, moe, ssm, hybrid, vlm, audio);
- ``collective_cost``'s effective bytes equal to
  ``repro.launch.hlo_analysis.collective_bytes``'s for the same (kind,
  bytes, group size);
- ``OpCost``'s live-byte accounting on a known sequence of ops;
- in a subprocess under the ``fake`` backend: the functional collectives
  counted with their group's size, and the dry run of the dense, moe and
  ssm smoke configs' prefill and decode cells ``ok`` on a (2, 2) and on
  the (16, 16) mesh, and ``main``'s record of a cell ``cell_applicable``
  rules out.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs.registry as jregistry
import repro.models.api as japi
from repro.launch.hlo_analysis import collective_bytes
from repro.launch.hlo_cost import analyze
from repro.models.config import SHAPE_CELLS, cell_applicable
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch.collective_cost import KINDS, effective_bytes
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.api import build_model, cache_specs, input_specs

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _dt(x) -> str:
    return (str(x.dtype).split(".")[1] if isinstance(x, torch.Tensor)
            else jnp.dtype(x.dtype).name)


def _arrays(tree, min_dim: int = 0) -> list:
    return [(tuple(x.shape), _dt(x)) for x in jax.tree.leaves(tree)
            if hasattr(x, "shape") and len(x.shape) >= min_dim]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch):
    from repro_torch.configs.registry import get_config

    cfg, jcfg = get_config(arch), jregistry.get_config(arch)
    for cell in SHAPE_CELLS:
        if not cell_applicable(jcfg, cell)[0]:
            continue
        got, want = input_specs(cfg, cell), japi.input_specs(jcfg, cell)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert (tuple(got[k].shape), _dt(got[k])) == (
                tuple(want[k].shape), _dt(want[k])), (cell.name, k)
        if cell.kind == "decode":
            # the port's lengths are one int (the reference's [L]
            # vectors: the continuous-batching divergence), so the
            # cache tensors are held, leaf by leaf
            cache = cache_specs(cfg, cell.global_batch, cell.seq_len)
            assert {t.device.type for t in jax.tree.leaves(cache)
                    if isinstance(t, torch.Tensor)} == {"meta"}
            assert _arrays(cache, 2) == _arrays(japi.cache_specs(
                jcfg, cell.global_batch, cell.seq_len), 2), cell.name
    with FakeTensorMode():  # fake CPU tensors under a caller's fake mode
        t = input_specs(cfg, SHAPE_CELLS[1])["tokens"]
        assert t.device.type == "cpu" and t.dtype == torch.int32


# one arch a family: dense, moe, ssm, hybrid, vlm, audio
FAMILY_ARCHS = ("qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-780m",
                "zamba2-1.2b", "pixtral-12b", "seamless-m4t-medium")


def _smoke_batch(cfg, b: int = 2, s: int = 64) -> dict:
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_op_cost_flops_equal_the_reference_hlo_cost(arch):
    jcfg = jregistry.smoke_config(arch)
    jmodel = japi.build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _smoke_batch(jcfg)
    jbatch = {k: jnp.asarray(v, jnp.dtype(jcfg.dtype) if v.dtype.kind == "f"
                             else v.dtype) for k, v in batch.items()}
    hlo = jax.jit(jmodel.forward).lower(jparams, jbatch).compile().as_text()
    want = analyze(hlo).flops

    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tbatch = {k: torch.from_numpy(v).to(getattr(torch, cfg.dtype))
              if v.dtype.kind == "f" else torch.from_numpy(v)
              for k, v in batch.items()}
    with torch.no_grad(), OpCost() as cost:
        model.forward(params, tbatch)
    assert cost.flops == want > 0
    assert cost.bytes > 0 and cost.cost.collective_bytes == 0
    rows = cost.top_traffic_ops(5)
    assert len(rows) == 5 and rows == sorted(
        rows, key=lambda r: -r["effective_bytes"])


@pytest.mark.parametrize("g", [2, 8, 16])
@pytest.mark.parametrize("kind", ["all-gather", "all-reduce", "all-to-all",
                                  "collective-permute", "reduce-scatter"])
def test_collective_effective_bytes_match_reference(kind, g):
    for elems in (1024, 3 * 4096):
        groups = ("source_target_pairs={{0,1}}" if kind ==
                  "collective-permute" else
                  f"replica_groups=[{256 // g},{g}]<=[256]")
        line = (f"  %c.1 = f32[{elems}]{{0}} {kind}(f32[{elems}] %p), "
                f"{groups}")
        want = collective_bytes(line, 256).bytes_by_kind[kind]
        g_eff = 2 if kind == "collective-permute" else g
        assert effective_bytes(kind, elems * 4, g_eff) == want
    assert kind in KINDS


def test_op_cost_tracks_live_and_peak_bytes():
    x = torch.ones(1000)  # 4000 B, live from the start
    with OpCost() as cost:
        assert cost.track({"x": x, "n": 3}) == 4000
        y = x * 2  # +4000
        z = y + 1  # +4000: peak 12000
        del y  # -4000
        w = z.view(10, 100)  # a view: no bytes, no new storage
        assert cost.live_bytes == 8000
    assert cost.peak_bytes == 12000 and cost.argument_bytes == 4000
    assert cost.bytes == 2 * (4000 + 4000)  # two ops: operand + result
    assert cost.flops == 0 and w.shape == (10, 100)


_FAKE_CODE = r"""
import json, sys, tempfile
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import repro_torch.launch.dryrun as d
from repro_torch.configs.registry import smoke_config
from repro_torch.launch.collective_cost import CollectiveCounter
from repro_torch.launch.mesh import _mesh, make_production_mesh
from repro_torch.models.config import ShapeCell
out = {"pg_after_import": dist.is_initialized()}
with tempfile.NamedTemporaryFile(suffix=".jsonl") as f:
    out["main_rc"] = d.main(["--arch", "qwen2.5-3b", "--shape", "long_500k",
                             "--out", f.name])
    out["main_rec"] = json.loads(open(f.name).read().splitlines()[0])
out["pg_after_main"] = dist.is_initialized()
cells = [ShapeCell("prefill_small", 256, 32, "prefill"),
         ShapeCell("decode_small", 256, 32, "decode")]
for world in (4, 256):
    d.start_fake_world(world)
    mesh = (_mesh((2, 2), ("data", "model"), "cpu") if world == 4
            else make_production_mesh(device_type="cpu"))
    group = mesh.get_group("model")
    with CollectiveCounter() as cc:
        t = torch.ones(8, 4)
        funcol.all_gather_tensor(t, 0, group)
        funcol.all_reduce(t, "sum", group)
        funcol.reduce_scatter_tensor(torch.ones(8 * mesh.size(1), 4), "sum",
                                     0, group)
    out[f"counter/{world}"] = [cc.stats.row(), mesh.size(1)]
    for arch in ("qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-780m"):
        for cell in cells:
            rec = d.run_cell(smoke_config(arch), cell, mesh)
            rec.pop("traceback", None)
            out[f"{world}/{arch}/{cell.name}"] = rec
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _FAKE_CODE],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dryrun_main_records_a_skipped_cell(fake_runs):
    assert fake_runs["pg_after_import"] is False
    assert fake_runs["pg_after_main"] is False
    assert fake_runs["main_rc"] == 0
    rec = fake_runs["main_rec"]
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert rec["route"] == ["plain attention"]


@pytest.mark.parametrize("world", ["4", "256"])
def test_collective_counter_reads_each_group(fake_runs, world):
    row, g = fake_runs[f"counter/{world}"]
    size = 8 * 4 * 4  # the gathered / reduced / scattered result
    assert row["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 1}
    assert row["by_kind"] == {
        "all-gather": effective_bytes("all-gather", size * g, g),
        "all-reduce": effective_bytes("all-reduce", size, g),
        "reduce-scatter": effective_bytes("reduce-scatter", size, g)}


@pytest.mark.parametrize("cell", ["prefill_small", "decode_small"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m",
                                  "mamba2-780m"])
@pytest.mark.parametrize("world", ["4", "256"])
def test_smoke_dryrun_cells_are_ok(fake_runs, world, arch, cell):
    rec = fake_runs[f"{world}/{arch}/{cell}"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["world"] == int(world)
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["peak_bytes"] >= rec["argument_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    assert rec["route"] == (["plain SSD"] if arch == "mamba2-780m"
                            else ["plain attention"])
    assert set(rec["collectives_by_axis"]) <= {"data", "model"}
