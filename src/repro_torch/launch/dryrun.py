"""Dry run of every (arch x shape cell x mesh) on the production meshes,
with no card and no allocation: the port's counterpart of the reference's
``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        --out build/dryrun.jsonl

``main`` starts the ``fake`` process-group backend (a ``FakeStore``, world
256, or 512 with ``--multi-pod``; its collectives move nothing) and builds
the production mesh over it. Each cell's params, AdamW state, batches and
caches are fake tensors (``FakeTensorMode``: shapes and dtypes, no
storage), placed as ``DTensor``s under the sharding rules (the caches
under the port's ``decode_cache_sharding``), and the cell's
computation (a train step, a prefill, a decode step) runs once under
:class:`~repro_torch.launch.op_cost.OpCost`: FLOPs, bytes, collective bytes
and live bytes of one device's shards. The reference compiles the cell and
reads XLA's HLO instead; where the two differ (no trip counts, no fusions,
``peak_bytes`` for ``memory_analysis``, the data-axes extent) is listed
in ROADMAP. Kernels cannot launch on fake tensors, so the cells take the
plain routes (plain attention, the plain SSD scan), and each record names
its ``route``. Importing this module touches no process-group state.

The roofline terms are against NVIDIA's datasheet constants for one H100
SXM5 80GB (dense, no sparsity), not measurements: 989 TFLOP/s bf16 and 67
TFLOP/s f32, 3.35 TB/s of HBM3, NVLink 4 at 450 GB/s a direction between
the 8 cards of a node, 400 Gb/s of InfiniBand a card between nodes. The
mesh is laid out with 8 cards a node and its last dim ("model") innermost:
an axis whose groups fit inside a node (its size times the product of the
sizes after it at most 8) runs on NVLink, any other crosses nodes; the
collective term sums each axis's bytes over its link.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.dist.sharding import (
    _data_axes,
    batch_sharding_tree,
    decode_cache_sharding,
    distribute_tree,
    is_dtensor,
    opt_state_sharding,
    param_sharding,
)
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.api import build_model, input_specs
from repro_torch.models.config import SHAPE_CELLS, cell_applicable

# NVIDIA H100 SXM5 80GB datasheet, per card (dense; not measured)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BPS = 3.35e12
NVLINK_BPS = 450e9  # NVLink 4, a direction
IB_BPS = 400e9 / 8  # 400 Gb/s InfiniBand, a card
NODE_CARDS = 8


def _microbatches(global_batch: int, batch_shards: int) -> int:
    """The reference's choice: 8 microbatches where they shard evenly,
    else 16, 4, 2, 1."""
    for n in (8, 16, 4, 2, 1):
        if global_batch % (n * batch_shards) == 0:
            return n
    return 1


def data_extent(mesh, batch: int) -> int:
    """The data-parallel ranks a batch is split over: the product of
    ``_data_axes``' axes (the reference imports an undefined
    ``batch_axis_size`` here)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[n] for n in _data_axes(sizes, batch) or ())


def axis_links(mesh) -> dict[str, float]:
    """Each mesh dim's link rate (bytes/s a device): NVLink where the
    dim's groups fit in a node, InfiniBand otherwise."""
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        span = mesh.size(i) * math.prod(mesh.shape[i + 1:])
        out[name] = NVLINK_BPS if span <= NODE_CARDS else IB_BPS
    return out


def build_cell(cfg, cell, mesh, generator: torch.Generator,
               device="cpu"):
    """The cell's computation and its inputs on ``device``, under the
    caller's ``FakeTensorMode``: ``(fn, args, extra)``; ``fn(*args)`` runs
    it."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.loop import TrainConfig, make_train_step

    model = build_model(cfg)
    params = model.init(generator, device=device)
    p_dist = distribute_tree(params, param_sharding(params, mesh))

    def specs():
        return {k: v.to(device) for k, v in input_specs(cfg, cell).items()}

    if cell.kind == "train":
        n_micro = cfg.micro_override or _microbatches(
            cell.global_batch, data_extent(mesh, cell.global_batch))
        step = make_train_step(model, TrainConfig(
            steps=10_000, n_microbatches=n_micro, opt=AdamWConfig()))
        opt = adamw_init(params)
        o_dist = distribute_tree(opt, opt_state_sharding(opt, mesh))
        batch = specs()
        b_dist = distribute_tree(batch, batch_sharding_tree(batch, mesh))
        return step, (p_dist, o_dist, b_dist), {"n_microbatches": n_micro}

    if cell.kind == "prefill":
        batch = specs()
        batch.pop("labels", None)
        b_dist = distribute_tree(batch, batch_sharding_tree(batch, mesh))

        def pre(params, batch):
            return model.prefill(params, batch, cell.seq_len)

        return pre, (p_dist, b_dist), {}

    # decode: one token against a seq_len cache
    tok = specs()
    t_dist = distribute_tree(tok, batch_sharding_tree(tok, mesh))["tokens"]
    cache = build_model(cfg).init_cache(cell.global_batch, cell.seq_len,
                                        device=device)
    c_dist = distribute_tree(cache, decode_cache_sharding(cache, mesh))
    return model.decode, (p_dist, t_dist, c_dist), {}


def route(cfg) -> list[str]:
    """The plain routes a dry run takes where the card has kernels."""
    r = []
    if cfg.family != "ssm":
        r.append("plain attention")
    if cfg.family in ("ssm", "hybrid"):
        r.append("plain SSD")
    return r


def measure(fn, args, *, train: bool) -> OpCost:
    """``fn(*args)`` once under :class:`OpCost`, with ``args`` live from the
    start (``OpCost.track``); a train step takes gradients, the other
    cells run without."""
    from torch.distributed.tensor.experimental import implicit_replication

    cost = OpCost()
    with cost, implicit_replication(), torch.set_grad_enabled(train):
        cost.track(args)
        out = fn(*args)
        del out
    return cost


def record(cfg, cell, mesh, cost: OpCost, world: int) -> dict:
    """The reference's roofline record of a measured cell."""
    flops, nbytes = cost.flops, cost.bytes
    n_active = cfg.active_param_count() - cfg.vocab_padded * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    model_flops = (6 if cell.kind == "train" else 2) * n_active * tokens
    groups = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
    by_axis: dict[str, float] = {}
    for g, b in cost.bytes_by_group.items():
        axis = groups.get(g, "other")
        by_axis[axis] = by_axis.get(axis, 0.0) + b
    links = axis_links(mesh)
    rec = {
        "world": world,
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collective_bytes_per_device": cost.stats.total_bytes,
        "collectives": {k: float(v)
                        for k, v in cost.stats.bytes_by_kind.items()},
        "collectives_by_axis": by_axis,
        "model_flops_total": float(model_flops),
        "useful_flops_ratio": float(model_flops / max(flops * world, 1)),
        "compute_term_s": flops / PEAK_FLOPS[cfg.dtype],
        "memory_term_s": nbytes / HBM_BPS,
        "collective_term_s": sum(b / links.get(a, IB_BPS)
                                 for a, b in by_axis.items()),
        "argument_bytes": cost.argument_bytes,
        "peak_bytes": cost.peak_bytes,
        "n_ops": cost.n_ops,
    }
    dom = max(("compute_term_s", "memory_term_s", "collective_term_s"),
              key=lambda k: rec[k])
    rec["bottleneck"] = dom.replace("_term_s", "")
    return rec


def run_cell(cfg, cell, mesh, *, multi_pod: bool = False,
             profile: bool = False) -> dict:
    """One cell's record for config ``cfg`` on ``mesh`` (the fake
    backend's production mesh), through plain attention; an error is
    recorded, not raised, so a sweep goes on."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg.replace(use_pallas_attention=False)
    ok, why = cell_applicable(cfg, cell)
    rec = {"arch": cfg.name, "shape": cell.name, "kind": cell.kind,
           "multi_pod": multi_pod, "seq_len": cell.seq_len,
           "global_batch": cell.global_batch, "route": route(cfg)}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        return rec
    world = math.prod(mesh.shape)
    t0 = time.time()
    try:
        with FakeTensorMode():
            fn, args, extra = build_cell(cfg, cell, mesh,
                                         torch.Generator().manual_seed(0))
            rec.update(extra)
            t_build = time.time() - t0
            cost = measure(fn, args, train=cell.kind == "train")
        rec.update(record(cfg, cell, mesh, cost, world))
        rec.update({"status": "ok", "build_s": round(t_build, 2),
                    "run_s": round(time.time() - t0 - t_build, 2)})
        if profile:
            rec["top_traffic_ops"] = cost.top_traffic_ops(15)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    return rec


def on_device(cfg, cell, mesh, device, *, plain: bool = False) -> dict:
    """A prefill or decode cell predicted and then run on ``device`` (a
    card) over ``mesh`` (a world-of-one mesh there), under the same
    counters and through the dry run's plain routes (plain attention,
    ``plain_ssd``): the prediction builds the cell from fake tensors, the
    run from params drawn on the card from a generator seeded 0 and tokens
    from ``np.random.default_rng(0)``. A decode cell's run takes its
    cache, under the port's placements (``decode_cache_sharding``), from a
    prefill of the cell's ``seq_len`` tokens, and then the next token; the
    prefill is set-up (the peak is taken after it), and each run of the
    step starts from the same prefilled cache. Returns both counts, the
    prediction's roofline terms, the rise of
    ``torch.cuda.max_memory_allocated`` over what was allocated before the
    run's inputs, the wall ms of the run without counters (best of 3,
    ended by a synchronise) and its last logits (a decode cell: also its
    new cache's tensors, whole, in order: ``cache``); with ``plain``, also
    the same from the same params and tokens as plain tensors (no mesh):
    ``plain_logits`` (and ``plain_cache``)."""
    from repro_torch.kernels.ssd_scan.ops import plain_ssd

    if cell.kind not in ("prefill", "decode"):
        raise ValueError("on_device runs prefill and decode cells, not "
                         f"{cell.kind!r}")
    cfg = cfg.replace(use_pallas_attention=False)
    with plain_ssd():
        return _on_device(cfg, cell, mesh, device, plain)


def _on_device(cfg, cell, mesh, device, plain: bool) -> dict:
    import numpy as np
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode():
        fn, args, _ = build_cell(cfg, cell, mesh,
                                 torch.Generator().manual_seed(0), device)
        pred = measure(fn, args, train=False)
    del fn, args
    world = math.prod(mesh.shape)
    out = {"predicted": record(cfg, cell, mesh, pred, world)}
    decode = cell.kind == "decode"

    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (cell.global_batch, cell.seq_len + decode),
        dtype=np.int32)).to(device)
    batch = {"tokens": toks[:, :cell.seq_len]}
    p_dist = distribute_tree(params, param_sharding(params, mesh))
    b_dist = distribute_tree(batch, batch_sharding_tree(batch, mesh))
    cache, filled = None, []
    if decode:
        tok = toks[:, cell.seq_len:]
        t_dist = distribute_tree({"t": tok}, batch_sharding_tree(
            {"t": tok}, mesh))["t"]
        with torch.no_grad(), implicit_replication():
            cache = model.prefill(p_dist, b_dist, cell.seq_len)[1]
        # kept on the host, out of the card's peak
        filled = [t.to_local().cpu() for t in _tensors(cache)]
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        args = (p_dist, t_dist, cache)
        fn = model.decode
    else:
        args = (p_dist, b_dist)

        def fn(p, b):
            return model.prefill(p, b, cell.seq_len)

    def refill():  # a decode step's prefilled cache again, in place
        for t, f in zip(_tensors(cache), filled):
            t.to_local().copy_(f)

    real = measure(fn, args, train=False)
    torch.cuda.synchronize(device)
    out["measured"] = {"flops": real.flops, "bytes": real.bytes,
                       "peak_bytes": real.peak_bytes,
                       "argument_bytes": real.argument_bytes,
                       "max_memory_allocated_rise":
                       torch.cuda.max_memory_allocated(device) - base}
    walls = []
    with torch.no_grad(), implicit_replication():
        for _ in range(3):
            refill()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            logits, new = fn(*args)
            torch.cuda.synchronize(device)
            walls.append((time.perf_counter() - t0) * 1e3)
    out["measured"]["ms"] = min(walls)
    out["logits"] = _whole(logits)
    if decode:
        out["cache"] = [_whole(t) for t in _tensors(new)]
    if plain:
        with torch.no_grad():
            if decode:
                pcache = model.prefill(params, batch, cell.seq_len)[1]
                out["plain_logits"], pcache = model.decode(params, tok,
                                                           pcache)
                out["plain_cache"] = _tensors(pcache)
            else:
                out["plain_logits"] = fn(params, batch)[0]
    return out


def _whole(t):
    return t.full_tensor() if is_dtensor(t) else t


def _tensors(tree) -> list:
    """The tensor leaves of a cache tree (dicts, lists, NamedTuples), in
    order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def start_fake_world(world: int) -> None:
    """The ``fake`` backend over a ``FakeStore``, as rank 0 of ``world``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv: list[str] | None = None) -> int:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    cells = [c for c in SHAPE_CELLS if not args.shape or c.name == args.shape]
    archs = list(ARCHS) if args.all or not args.arch else [args.arch]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    out_f = open(args.out, "a") if args.out else None
    try:
        for mp in meshes:
            start_fake_world(512 if mp else 256)
            try:
                mesh = make_production_mesh(multi_pod=mp, device_type="cpu")
                for arch in archs:
                    for cell in cells:
                        rec = run_cell(get_config(arch), cell, mesh,
                                       multi_pod=mp, profile=args.profile)
                        n_fail += _report(rec, out_f)
            finally:
                dist.destroy_process_group()
    finally:
        if out_f:
            out_f.close()
    return 1 if n_fail else 0


def _report(rec: dict, out_f) -> int:
    """Print a record's line (and write it to ``out_f``); 1 for an error."""
    tag = "POD2" if rec["multi_pod"] else "POD1"
    line = f"[{tag}] {rec['arch']:22s} {rec['shape']:12s} {rec['status']:8s}"
    if rec["status"] == "ok":
        line += (f" run={rec['run_s']:.1f}s "
                 f"bottleneck={rec['bottleneck']:10s} "
                 f"useful={rec['useful_flops_ratio']:.2f} "
                 f"peak={rec['peak_bytes'] / 2**30:.2f}GiB")
    elif rec["status"] == "error":
        line += " " + rec["error"][:120]
    print(line, flush=True)
    if out_f:
        slim = {k: v for k, v in rec.items() if k != "traceback"}
        out_f.write(json.dumps(slim) + "\n")
        out_f.flush()
    return rec["status"] == "error"


if __name__ == "__main__":
    sys.exit(main())
