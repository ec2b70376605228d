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
  rules out;
- in one subprocess, six production cells on the (16, 16) mesh through
  the port's ``run_cell`` and the reference's (granite-moe's prefill_32k,
  zamba2's decode_32k, mamba2's prefill_32k: the MoE, the hybrid's
  sequence-sharded cache, the SSM heads; h2o-danube's and mamba2's
  long_500k: a B = 1 decode split over the idle data axes; mamba2's
  decode_32k: the SSM state head-sharded on "model"), held to
  ``dryrun_compare``'s limits: FLOPs a device within 1.10x of the
  reference's HLO count (at most 1.10x for long_500k), the peak within
  3x of its memory (argument + output + temp - alias; prefill_32k /
  decode_32k) and under 80e9 B, the ssm and hybrid decodes' collective
  bytes within 10x, mamba2's decode_32k not ``collective``-bound; and at
  smoke size, a hybrid decode step's collective bytes the same for twice
  the cache.
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


_PARITY_CODE = r"""
import json
import repro.launch.dryrun as ref  # first: 512 host devices for XLA
import torch.distributed as dist
import repro_torch.launch.dryrun as d
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.config import SHAPE_CELLS, ShapeCell
cells = {c.name: c for c in SHAPE_CELLS}
out = {}
for arch, shape in PARITY_CELLS:
    r = ref.run_cell(arch, cells[shape])
    m = r.get("memory_analysis", {})
    out[f"ref/{arch}/{shape}"] = {
        "status": r["status"], "flops": r.get("flops_per_device"),
        "collective": r.get("collective_bytes_per_device"),
        "memory": sum(m.get(k, 0) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes")) - m.get("alias_size_in_bytes", 0)}
d.start_fake_world(256)
try:
    mesh = make_production_mesh(device_type="cpu")
    for arch, shape in PARITY_CELLS:
        r = d.run_cell(get_config(arch), cells[shape], mesh)
        out[f"port/{arch}/{shape}"] = {
            "status": r["status"], "error": r.get("error"),
            "flops": r.get("flops_per_device"),
            "collective": r.get("collective_bytes_per_device"),
            "peak": r.get("peak_bytes"), "bottleneck": r.get("bottleneck")}
    for s_max in (64, 128):
        r = d.run_cell(smoke_config("zamba2-1.2b"),
                       ShapeCell("decode_small", s_max, 256, "decode"), mesh)
        out[f"smoke/{s_max}"] = [r["status"],
                                 r.get("collective_bytes_per_device")]
finally:
    dist.destroy_process_group()
print(json.dumps(out))
"""

PARITY_CELLS = [("granite-moe-1b-a400m", "prefill_32k"),
                ("zamba2-1.2b", "decode_32k"), ("mamba2-780m", "prefill_32k"),
                ("h2o-danube-1.8b", "long_500k"),
                ("mamba2-780m", "long_500k"), ("mamba2-780m", "decode_32k")]


@pytest.fixture(scope="module")
def parity_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    code = f"PARITY_CELLS = {PARITY_CELLS!r}\n" + _PARITY_CODE
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", PARITY_CELLS)
def test_production_cells_place_their_work_as_the_reference(parity_runs,
                                                            arch, shape):
    """The MoE's expert parallelism, the SSM's heads on "model", the
    hybrid's decode against its sequence-sharded cache, a B = 1 decode's
    products split over the idle data axes and the SSM state kept
    head-sharded leave each device the reference's share of the work:
    FLOPs within 1.10x of the reference's HLO count (either way; at most
    1.10x for long_500k, where the port may do less), the peak under one
    card's 80e9 B and, for prefill_32k / decode_32k, within 3x of the
    reference's memory; the ssm and hybrid decodes move within 10x of the
    reference's collective bytes (the cache and the state are never
    gathered), and mamba2's decode_32k is not ``collective``-bound."""
    ref = parity_runs[f"ref/{arch}/{shape}"]
    port = parity_runs[f"port/{arch}/{shape}"]
    assert ref["status"] == "ok"
    assert port["status"] == "ok", port["error"]
    assert port["flops"] / ref["flops"] <= 1.10
    assert port["peak"] < 80e9
    if shape != "long_500k":
        assert 1 / 1.10 <= port["flops"] / ref["flops"]
        assert port["peak"] <= 3 * ref["memory"]
    if arch in ("zamba2-1.2b", "mamba2-780m") and "prefill" not in shape:
        assert port["collective"] <= 10 * ref["collective"]
    if (arch, shape) == ("mamba2-780m", "decode_32k"):
        assert port["bottleneck"] != "collective"


def test_on_device_runs_prefill_and_decode_cells_only():
    """``on_device`` ties a prefill or a decode cell to the card; a train
    cell is refused before anything is built."""
    from repro_torch.launch.dryrun import on_device
    from repro_torch.models.config import ShapeCell

    with pytest.raises(ValueError, match="prefill and decode cells"):
        on_device(smoke_config("mamba2-780m"),
                  ShapeCell("train_small", 64, 2, "train"), None, "cpu")


def test_hybrid_decode_collectives_do_not_grow_with_the_cache(parity_runs):
    """A zamba2 smoke decode step on the (16, 16) mesh, its cache sharded
    on S_max: twice the cache, the same collective bytes (each rank
    attends its slice; the merge moves [B, 1, H/M, Dh + 1])."""
    (st64, c64), (st128, c128) = parity_runs["smoke/64"], \
        parity_runs["smoke/128"]
    assert st64 == st128 == "ok"
    assert c64 == c128 > 0


def _records(tmp_path, port_changes: dict) -> tuple:
    """A port and a reference JSONL of one hybrid decode_32k cell and one
    moe train_4k cell (no reference figure), the port's figures changed
    by ``port_changes`` (an ``arch`` or ``shape`` there names the first
    cell in both)."""
    ref = {"arch": "zamba2-1.2b", "shape": "decode_32k", "multi_pod": False,
           "status": "ok", "flops_per_device": 4e9,
           "collective_bytes_per_device": 3e9,
           "memory_analysis": {"argument_size_in_bytes": 16e9,
                               "output_size_in_bytes": 30e9,
                               "temp_size_in_bytes": 4e9,
                               "alias_size_in_bytes": 30e9}}
    port = {"arch": "zamba2-1.2b", "shape": "decode_32k", "multi_pod": False,
            "status": "ok", "flops_per_device": 4.1e9,
            "collective_bytes_per_device": 1e9, "peak_bytes": 31e9}
    port.update(port_changes)
    ref.update({k: port[k] for k in ("arch", "shape")})
    train = {"arch": "granite-moe-1b-a400m", "shape": "train_4k",
             "multi_pod": True, "status": "ok", "flops_per_device": 1e14,
             "collective_bytes_per_device": 3e12, "peak_bytes": 16e9}
    ref_train = dict(train, status="error", error="ImportError: x")
    paths = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    paths[0].write_text(json.dumps(port) + "\n" + json.dumps(train) + "\n")
    paths[1].write_text(json.dumps(ref) + "\n" + json.dumps(ref_train)
                        + "\n")
    return tuple(str(p) for p in paths)


@pytest.mark.parametrize("changes,failure", [
    ({}, None),
    ({"flops_per_device": 4.5e9}, "FLOPs 1.125x"),
    ({"flops_per_device": 3.5e9}, "FLOPs 0.875x"),
    ({"peak_bytes": 103e9}, "peak 1.03e+11 B"),
    ({"peak_bytes": 61e9}, "3.05x the reference's memory"),
    ({"collective_bytes_per_device": 3.1e10}, "collective bytes 10.3x"),
    ({"status": "error", "error": "ValueError: rows"}, "error ValueError"),
    ({"shape": "long_500k", "flops_per_device": 0.5e9}, None),
    ({"shape": "long_500k", "flops_per_device": 4.5e9}, "FLOPs 1.125x"),
    ({"arch": "mamba2-780m", "collective_bytes_per_device": 3.1e10},
     "collective bytes 10.3x"),
    ({"arch": "mamba2-780m", "shape": "long_500k",
      "collective_bytes_per_device": 3.1e10}, "collective bytes 10.3x"),
])
def test_dryrun_compare_holds_the_cells_to_their_limits(tmp_path, capsys,
                                                        changes, failure):
    """``dryrun_compare`` reads both packages' JSONL records, puts the
    reference's memory (argument + output + temp - alias) and the ratios
    beside each cell, and fails a cell over its limit: FLOPs outside
    1.10x either way (long_500k: over 1.10x only), a peak over 80e9 B, a
    moe / ssm / hybrid peak over 3x the reference's memory, an ssm or
    hybrid decode_32k / long_500k over 10x its collective bytes, an
    error; a train cell with no reference figure is held to ``ok`` and
    the peak only."""
    from repro_torch.launch import dryrun_compare

    rc = dryrun_compare.main(list(_records(tmp_path, changes)))
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    if failure is None:
        assert rc == 0 and summary["failed"] == []
        assert summary["cells"] == {"ok": 2}
        row = json.loads(lines[0])
        assert row["ref_memory"] == 20e9
        assert row["flops_ratio"] == pytest.approx(
            changes.get("flops_per_device", 4.1e9) / 4e9)
        assert "flops_ratio" not in json.loads(lines[1])  # no reference
    else:
        assert rc == 1
        assert any(failure in f for f in summary["failed"]), summary
    rc = dryrun_compare.main([*_records(tmp_path, changes), "--markdown"])
    table = capsys.readouterr().out
    assert f"| {changes.get('arch', 'zamba2-1.2b')} (16, 16) |" in table
    assert "| granite-moe-1b-a400m (2, 16, 16) | 1e+14 / 16 GB (no ref)" \
        in table
