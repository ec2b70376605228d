"""One rank of the port's multi-rank CPU tests (gloo), run as a script:

    python tests/torch_dist_ranks.py SUITE RANK WORLD STORE INPUTS OUT

``SUITE`` is ``collectives`` (the four rings on a ring of 4 and on the
model dim of a (2, 2) mesh, their hop counts and divisibility errors) or
``dist`` (the smoke qwen loss sharded on a (2, 2) mesh, the loss, prefill
and decode of a smoke config of each other family sharded the same way,
the expert-parallel MoE layer's seats and outputs, attention against a
cache sharded on its sequence, the zamba2 decode steps across the cache's
shards, microbatches of the global batch, B = 1 decodes with their
products split over "data" and the SSM state's heads kept on "model",
sharded batch staging under the three managements, the kernels' refusal
of DTensors).
The ranks meet through a ``FileStore`` at ``STORE``, read their inputs
from the ``.npz`` at ``INPUTS`` and write their readings to
``OUT/SUITE-RANK.pt``; ``tests/test_torch_collectives.py`` and
``tests/test_torch_dist.py`` start the four ranks once a module and hold
the readings against the reference. Imports neither jax nor the
reference package.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def _hops(fn):
    """``fn()`` and the number of ``batch_isend_irecv`` calls it made."""
    calls = []
    orig = dist.batch_isend_irecv

    def counted(ops):
        calls.append(len(ops))
        return orig(ops)

    dist.batch_isend_irecv = counted
    try:
        out = fn()
    finally:
        dist.batch_isend_irecv = orig
    return out, len(calls)


def _error(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def collectives(rank: int, world: int, inputs: dict) -> dict:
    from repro_torch.core import pipeline_collectives as pc
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    rings = {"ring4": make_local_mesh(world, device_type="cpu"),
             "ring2": make_local_mesh(2, device_type="cpu")}
    for name, mesh in rings.items():
        group = mesh.get_group("model")
        n = dist.get_world_size(group)
        r = dist.get_rank(group)
        t = {k: torch.from_numpy(v) for k, v in inputs.items()}
        x, w = t["x"], t["w"]
        m = x.shape[0] // n
        cases = {
            "ag": lambda: pc.ring_all_gather(x[r * m:(r + 1) * m], group),
            "ag_axis1": lambda: pc.ring_all_gather(
                t["x1"][:, r * (t["x1"].shape[1] // n):
                        (r + 1) * (t["x1"].shape[1] // n)], group, axis=1),
            "rs": lambda: pc.ring_reduce_scatter(t["xr"][rank], group),
            "mm_ag": lambda: pc.overlapped_matmul_ag(
                x[r * m:(r + 1) * m], w, group),
            "mm_rs": lambda: pc.overlapped_matmul_rs(
                t["xm"][:, r * (t["xm"].shape[1] // n):
                        (r + 1) * (t["xm"].shape[1] // n)],
                t["wm"][r * (t["wm"].shape[0] // n):
                        (r + 1) * (t["wm"].shape[0] // n)], group),
        }
        for case, fn in cases.items():
            y, hops = _hops(fn)
            out[f"{name}/{case}"] = y.numpy()
            out[f"{name}/{case}/hops"] = hops
        out[f"{name}/rs_error"] = _error(
            lambda: pc.ring_reduce_scatter(t["xr"][rank][:7], group))
        out[f"{name}/mm_rs_error"] = _error(
            lambda: pc.overlapped_matmul_rs(t["xm"][:7], t["wm"][:24 // n],
                                            group))
        out[f"{name}/group_rank"] = r
    return out


def sharded_dist(rank: int, world: int, inputs: dict) -> dict:
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import smoke_config
    from repro_torch.core.transfer import TransferEngine, TransferPolicy
    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    from repro_torch.dist.sharding import (
        batch_sharding_tree, distribute_tree, param_sharding)
    from repro_torch.kernels.conv2d.kernel import conv2d_igemm
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_bshd)
    from repro_torch.kernels.ssd_scan.kernel import (
        ssd_intra_chunk_call, ssd_state_pass_call)
    from repro_torch.kernels.streamed_matmul.kernel import (
        matmul_blocks, matmul_unique)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.utils.pytree import tree_leaves

    out = {}
    mesh = make_local_mesh(2, device_type="cpu")
    out["mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names),
                   mesh.device_type)

    # the smoke qwen loss: params under param_sharding, the batch under
    # batch_sharding_tree, against the same loss on whole tensors
    cfg = smoke_config("qwen2.5-3b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(inputs["tokens"]),
             "labels": torch.from_numpy(inputs["labels"])}
    with torch.no_grad():
        out["loss_single"] = float(model.loss(params, batch)[0])
        p_sh = param_sharding(params, mesh)
        b_sh = batch_sharding_tree(batch, mesh)
        ps = distribute_tree(params, p_sh)
        bs = distribute_tree(batch, b_sh)
        with implicit_replication():
            loss = model.loss(ps, bs)[0]
        out["loss_sharded"] = float(loss.full_tensor()
                                    if isinstance(loss, DTensor) else loss)
    out["params_sharded"] = sum(
        any(p.is_shard() for p in t.placements) for t in tree_leaves(ps))
    out["params_leaves"] = len(tree_leaves(ps))

    out["families"] = _families(mesh, inputs)
    out["train_step"] = {n: _train_step(mesh, inputs, n) for n in (2, 4)}
    out["moe_layer"] = _moe_layer(mesh)
    out["seq_cache"] = _seq_cache(mesh)
    out["hybrid_steps"] = _hybrid_steps(mesh, inputs)
    out["micro"] = _micro(mesh)
    out["b1_decode"] = _b1_decode(mesh)

    # sharded staging under each management, with and without an engine
    src = SyntheticLMSource(DataConfig(8, 16, seed=3), cfg)
    host = [src.next_host_batch(i) for i in range(2)]
    staged = {}
    for tag, policy in (("polling", TransferPolicy.user_level_polling()),
                        ("scheduled", TransferPolicy.user_level_scheduled()),
                        ("interrupt", TransferPolicy.kernel_level())):
        for with_engine in (False, True):
            eng = (TransferEngine(policy, device="cpu") if with_engine
                   else None)
            shard = batch_sharding_tree(host[0], mesh)
            pipe = StagedPipeline(src, policy, shardings=shard, engine=eng,
                                  device="cpu")
            got = []
            try:
                for _ in range(2):
                    b = next(pipe)
                    got.append({k: (type(v).__name__, tuple(v.shape),
                                    [str(p) for p in v.placements],
                                    v.to_local().numpy().copy(),
                                    v.full_tensor().numpy().copy())
                                for k, v in b.items()})
            finally:
                pipe.close()
            tx = None
            if eng is not None:
                tx = [st.nbytes for st in list(eng.stats)
                      if st.direction == "tx"]
                eng.close()
            staged[f"{tag}/{'engine' if with_engine else 'plain'}"] = (
                got, tx)
    out["staged"] = staged
    out["host_bytes"] = [sum(v.nbytes for v in h.values()) for h in host]
    out["host"] = host

    # the kernels refuse a DTensor before anything else
    d = distribute_tensor(torch.ones(4, 4), mesh, list(
        batch_sharding_tree({"t": torch.ones(4, 4)}, mesh)["t"].placements))
    refusals = {
        "conv2d": lambda: conv2d_igemm(d, d, d),
        "matmul_blocks": lambda: matmul_blocks(d, d),
        "matmul_unique": lambda: matmul_unique(d, d),
        "flash": lambda: flash_attention_bshd(d, d, d),
        "ssd_intra_chunk": lambda: ssd_intra_chunk_call(d, d, d, d, d,
                                                        chunk=4),
        "ssd_state_pass": lambda: ssd_state_pass_call(d, d),
    }
    for name, fn in refusals.items():
        try:
            fn()
            out[f"refuse/{name}"] = None
        except TypeError as e:
            out[f"refuse/{name}"] = str(e)
    return out


# one smoke config of each family that runs other code under DTensor than
# the dense qwen above: GQA with 3 q heads a shard against 1 KV head
# (internlm2), the MoE with expert sharding on (granite), the SSM mixer,
# the hybrid's shared attention (its one-layer cache sharded on S_max by
# the rules), the encoder-decoder's cross-attention caches, the vlm prefix
FAMILIES = ("internlm2-20b", "granite-moe-1b-a400m", "mamba2-780m",
            "zamba2-1.2b", "seamless-m4t-medium", "pixtral-12b")


def _families(mesh, inputs: dict) -> dict:
    """Each of ``FAMILIES`` in f32: the loss, a prefill's last logits, one
    decode step's logits and the loss's gradients, on whole tensors and
    with params, batch and caches as DTensors on ``mesh``; for the MoE the
    placement each ``_shard_experts`` site returned."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.models.layers.moe as moe
    import repro_torch.models.layers.ssm as ssm
    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist.sharding import (
        batch_sharding_tree, distribute_tree, param_sharding)
    from repro_torch.models.api import build_model
    from repro_torch.train.loop import value_and_grad
    from repro_torch.utils.pytree import tree_leaves

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    sites = []
    orig = moe._shard_experts

    def spy(x, spec):
        y = orig(x, spec)
        sites.append((tuple(spec), [str(p) for p in y.placements]
                      if isinstance(y, DTensor) else None))
        return y

    moe._shard_experts = spy
    mixers = []  # (heads, rows) of each mixer call over DTensors
    core = ssm._mamba2_core

    def heads_spy(p, z, *args, **kw):
        mixers.append((z.shape[-1], z.shape[0] * z.shape[1]))
        return core(p, z, *args, **kw)

    res = {}
    try:
        for arch in FAMILIES:
            cfg = smoke_config(arch).replace(dtype="float32")
            if cfg.family == "moe":
                cfg = cfg.replace(moe_ep_sharding=True)
            model = build_model(cfg)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            toks = torch.from_numpy(inputs["tokens"]).long()
            labels = torch.from_numpy(inputs["labels"]).long()
            gen = torch.Generator().manual_seed(1)
            batch = {"tokens": toks, "labels": labels}
            if cfg.family == "vlm":
                batch["patch_embeds"] = torch.randn(
                    (toks.shape[0], cfg.n_prefix_tokens, cfg.d_model),
                    generator=gen)
            if cfg.family == "audio":
                batch["frames"] = torch.randn(
                    (toks.shape[0], toks.shape[1], cfg.d_model),
                    generator=gen)
            s_max = toks.shape[1] + cfg.n_prefix_tokens * (
                cfg.family == "vlm") + 4
            prompt = {k: v for k, v in batch.items() if k != "labels"}
            got = {}
            with torch.no_grad():
                lg, cache = model.prefill(params, prompt, s_max)
                tok = lg.argmax(-1)
                got["single"] = (float(model.loss(params, batch)[0]),
                                 lg.numpy(),
                                 model.decode(params, tok, cache)[0].numpy())
                del sites[:]
                ssm._mamba2_core = heads_spy
                ps = distribute_tree(params, param_sharding(params, mesh))
                bs = distribute_tree(batch, batch_sharding_tree(batch, mesh))
                ts = distribute_tree({"t": tok}, batch_sharding_tree(
                    {"t": tok}, mesh))["t"]
                with implicit_replication():
                    loss = model.loss(ps, bs)[0]
                    slg, scache = model.prefill(
                        ps, {k: v for k, v in bs.items() if k != "labels"},
                        s_max)
                    dlg = model.decode(ps, ts, scache)[0]
                got["sharded"] = (float(whole(loss)), whole(slg), whole(dlg))
                ssm._mamba2_core = core
            got["sites"] = list(sites)
            got["mixers"] = list(mixers)
            del mixers[:]
            with implicit_replication():
                got["grads"] = [
                    [whole(g) for g in tree_leaves(
                        value_and_grad(model, p, b)[2])]
                    for p, b in ((params, batch), (ps, bs))]
            res[arch] = got
    finally:
        moe._shard_experts = orig
        ssm._mamba2_core = core
    return res


def _train_step(mesh, inputs: dict, n_micro: int) -> dict:
    """One AdamW step of the smoke qwen in f32 with ``n_micro``
    microbatches, on whole tensors and with params, AdamW state and batch
    as DTensors on ``mesh``: the loss, the gradient norm and every updated
    leaf."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist.sharding import (
        batch_sharding_tree, distribute_tree, opt_state_sharding,
        param_sharding)
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.utils.pytree import tree_leaves

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).numpy()

    cfg = smoke_config("qwen2.5-3b").replace(dtype="float32")
    model = build_model(cfg)
    step = make_train_step(model, TrainConfig(steps=10, warmup=2,
                                              n_microbatches=n_micro))
    batch = {k: torch.from_numpy(inputs[k]).long()
             for k in ("tokens", "labels")}
    res = {}
    for tag in ("single", "sharded"):
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        opt = adamw_init(params)
        b = batch
        if tag == "sharded":
            params = distribute_tree(params, param_sharding(params, mesh))
            opt = distribute_tree(opt, opt_state_sharding(opt, mesh))
            b = distribute_tree(batch, batch_sharding_tree(batch, mesh))
        with implicit_replication():
            params, opt, metrics = step(params, opt, b)
        res[tag] = (float(whole(metrics["loss"])),
                    float(whole(metrics["grad_norm"])),
                    [whole(t.detach()) for t in tree_leaves(params)])
    return res


def _whole(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


# (arch, dtype, capacity factor, ep_sharding): the granite and deepseek
# smoke layers (E 4, top-2 / top-6 with 2 shared experts) at 128 tokens;
# capacity 1.25 gives C 80 < 3 F (the few-seats layout), 0.5 drops seats,
# 4.0 gives C 256 >= 3 F (the many-seats layout)
MOE_CASES = [(a, dt, cf, False) for a in ("granite-moe-1b-a400m",
                                          "deepseek-moe-16b")
             for dt in ("float32", "bfloat16") for cf in (1.25, 0.5, 4.0)]
MOE_CASES.append(("granite-moe-1b-a400m", "float32", 1.25, True))


def _moe_layer(mesh) -> dict:
    """Each of ``MOE_CASES``: the MoE layer on whole tensors and over
    DTensors (params under the rules, x's rows on "data"): the output,
    aux, the seats of every call (this rank's block when sharded) and, in
    f32, the gradients of a weighted sum of the output and aux."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    import repro_torch.models.layers.moe as moe
    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist.sharding import (
        batch_sharding_tree, distribute_tree, param_sharding)

    seats = []
    orig = moe._seats

    def spy(*args, **kw):
        r = orig(*args, **kw)
        seats.append({k: getattr(r, k).detach().clone()
                      for k in ("keep", "slot", "f_e", "dropped")})
        return r

    res = {}
    moe._seats = spy
    try:
        for arch, dt, cf, ep in MOE_CASES:
            cfg = smoke_config(arch)
            dtype = getattr(torch, dt)
            g = torch.Generator().manual_seed(7)
            p = moe.moe_params(g, cfg.d_model, cfg.n_experts, cfg.d_expert,
                               cfg.n_shared_experts, dtype)
            x = torch.randn(4, 32, cfg.d_model, generator=g).to(dtype)
            cot = torch.randn(4, 32, cfg.d_model, generator=g).to(dtype)
            grad = dtype == torch.float32
            kw = dict(top_k=cfg.top_k, capacity_factor=cf, ep_sharding=ep)
            x_pl = list(batch_sharding_tree({"x": x}, mesh)["x"].placements)
            got = {}
            for tag in ("whole", "sharded"):
                pt, xt, ct = p, x, cot
                if tag == "sharded":
                    pt = distribute_tree(p, param_sharding(p, mesh))
                    xt = distribute_tensor(x, mesh, x_pl)
                    ct = distribute_tensor(cot, mesh, x_pl)
                pt = {k: v.detach().requires_grad_(grad)
                      for k, v in pt.items()}
                xt = xt.detach().requires_grad_(grad)
                del seats[:]
                with torch.set_grad_enabled(grad), implicit_replication():
                    y, metrics = moe.moe_apply(pt, xt, **kw)
                    if grad:
                        ((y * ct).sum() + 3.0 * metrics.aux_loss).backward()
                got[tag] = {
                    "out": _whole(y.detach()), "seats": seats[0],
                    "aux": float(_whole(metrics.aux_loss.detach())),
                    "dropped": float(metrics.dropped_frac),
                    "grads": {k: _whole(v.grad) for k, v in
                              [*pt.items(), ("x", xt)]} if grad else None}
            res[(arch, dt, cf, ep)] = got
    finally:
        moe._seats = orig
    return res


# (name, cached tokens, new tokens): an int length, a 0-d tensor (a),
# per-slot [B] lengths (v), over a 32-position cache split 2 x 16 on
# "data"; positions 15 and 16 are the last column of rank 0's slice and
# the first of rank 1's
SEQ_CASES = [("prefill", 0, 5), ("prefill_whole", 0, 32),
             ("last_col_of_slice_0", 15, 1), ("first_col_of_slice_1", 16, 1),
             ("across_slices", 14, 3), ("tensor_length", "a16", 1),
             ("per_slot", "v3,16,20,31", 1), ("per_slot_past_end",
                                               "v31,32,40,0", 1)]


def _seq_cache(mesh) -> dict:
    """``attend_projected`` against a cache the rules shard on its
    sequence ([B, S_max, Hkv, Dh], S_max on "data") for each of
    ``SEQ_CASES``, on whole tensors and over DTensors (q / k / v rows on
    "data", columns on "model"): the output and, after the write, this
    rank's cache shards beside the whole cache's."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.dist.sharding import cache_sharding
    from repro_torch.models.layers.attention import KVCache, attend_projected

    b, s_max, h, hkv, dh = 4, 32, 4, 2, 16
    res = {}
    for name, length, s in SEQ_CASES:
        g = torch.Generator().manual_seed(11)
        q, k, v = (torch.randn(b, s, n * dh, generator=g)
                   for n in (h, hkv, hkv))
        ck, cv = (torch.randn(b, s_max, hkv, dh, generator=g)
                  for _ in range(2))
        if isinstance(length, str) and length[0] == "a":
            length = torch.tensor(int(length[1:]))
        elif isinstance(length, str):
            length = torch.tensor([int(n) for n in length[1:].split(",")])
        kw = dict(n_heads=h, n_kv=hkv, head_dim=dh, rope_theta=10_000.0,
                  window=0, kv_chunk=16, blocks_threshold=64,
                  use_pallas=False, positions=None, cross=False, causal=True)
        with torch.no_grad():
            whole = KVCache(ck.clone(), cv.clone(), length)
            o_w, w_new = attend_projected(q, k, v, cache=whole, **kw)
            cache = KVCache(ck.clone(), cv.clone(), length)
            sh = cache_sharding(cache, mesh)
            dcache = KVCache(*(distribute_tensor(t, mesh, list(p.placements))
                               for t, p in zip(cache[:2], sh[:2])), length)
            # projections: rows on "data", columns on "model"
            qkv = [distribute_tensor(t, mesh, [Shard(0), Shard(2)])
                   for t in (q, k, v)]
            o_s, new = attend_projected(*qkv, cache=dcache, **kw)
        res[name] = {"out": (o_w, _whole(o_s)),
                     "placements": [str(p) for p in dcache.k.placements],
                     "length": (w_new.length, new.length),
                     "shards": [(t.to_local().clone(), w) for t, w in
                                ((dcache.k, whole.k), (dcache.v, whole.v))]}
    return res


def _hybrid_steps(mesh, inputs: dict) -> dict:
    """The zamba2 smoke model in f32: a prompt of 15 tokens into a 32
    position cache (sharded 2 x 16 on "data" by the rules), then decode
    steps at positions 15 and 16 (the last column of rank 0's slice and
    the first of rank 1's), on whole tensors and over DTensors: each
    step's logits, and each cache's K shards after the last step."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist.sharding import (
        batch_sharding_tree, distribute_tree, param_sharding)
    from repro_torch.models.api import build_model

    cfg = smoke_config("zamba2-1.2b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(inputs["tokens"][:, :15]).long()
    res = {}
    for tag in ("whole", "sharded"):
        p, t = params, {"tokens": toks}
        if tag == "sharded":
            p = distribute_tree(params, param_sharding(params, mesh))
            t = distribute_tree(t, batch_sharding_tree(t, mesh))
        logits = []
        with torch.no_grad(), implicit_replication():
            lg, cache = model.prefill(p, t, 32)
            logits.append(_whole(lg))
            for _ in range(2):
                tok = _whole(lg).argmax(-1)
                if tag == "sharded":
                    tok = distribute_tree({"t": tok}, batch_sharding_tree(
                        {"t": tok}, mesh))["t"]
                lg, cache = model.decode(p, tok, cache)
                logits.append(_whole(lg))
        res[tag] = {"logits": logits,
                    "k": [c["kv"].k.to_local().clone()
                          if isinstance(c["kv"].k, DTensor) else c["kv"].k
                          for c in cache],
                    "placements": [[str(q) for q in c["kv"].k.placements]
                                   for c in cache] if tag == "sharded"
                    else None}
    return res


# (arch, prompt tokens, cache positions, decode steps) of the B = 1
# decodes: h2o-danube's smoke window (32) slices the cache read once the
# cache holds over 128 positions; mamba2's state stays O(1)
B1_CASES = (("h2o-danube-1.8b", 144, 160, 1), ("mamba2-780m", 16, 16, 3))


def _b1_decode(mesh) -> dict:
    """Each of ``B1_CASES`` in f32 at B = 1 (rows the batch rule cannot
    put on "data"): a prompt, then decode steps, on whole tensors and over
    DTensors (params under the rules, the cache from the port's prefill),
    each step's logits; the local products and collectives (kind, mesh
    dim, result shape) of the first sharded step and of the same step on
    whole tensors; for the SSM, the state's placements and this rank's
    shard beside the whole state after the steps, and the same first step
    from a cache on the reference's rule (``cache_sharding``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import smoke_config
    from repro_torch.dist.sharding import (
        batch_sharding_tree, cache_sharding, distribute_tree,
        param_sharding)
    from repro_torch.launch.collective_cost import collective_of
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.api import build_model

    groups = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}

    class Seen(OpCost):
        """OpCost, keeping each product's operand shapes and each
        collective's (kind, mesh dim, result shape)."""

        def __init__(self):
            super().__init__()
            self.products, self.collectives = [], []

        def record(self, func, args, out):
            super().record(func, args, out)
            if func._overloadpacket in (torch.ops.aten.mm,
                                        torch.ops.aten.addmm):
                self.products.append(tuple(
                    tuple(a.shape) for a in args
                    if isinstance(a, torch.Tensor))[-2:])
            hit = collective_of(func, args)
            if hit is not None:
                self.collectives.append((hit[0], groups.get(hit[2]),
                                         tuple(out.shape)))

    def seen_step(model, p, tok, cache):
        seen = Seen()
        with seen:
            lg = model.decode(p, tok, cache)[0]
        return lg, {"flops": seen.flops, "products": seen.products,
                    "collectives": seen.collectives}

    res = {}
    for arch, prompt, s_max, steps in B1_CASES:
        cfg = smoke_config(arch).replace(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        toks = torch.from_numpy(np.random.default_rng(9).integers(
            0, cfg.vocab, (1, prompt + steps))).long()
        got = {}
        for tag in ("whole", "sharded"):
            p, b = params, {"tokens": toks[:, :prompt]}
            if tag == "sharded":
                p = distribute_tree(params, param_sharding(params, mesh))
                b = distribute_tree(b, batch_sharding_tree(b, mesh))
            logits, seen = [], None
            with torch.no_grad(), implicit_replication():
                lg, cache = model.prefill(p, b, s_max)
                logits.append(_whole(lg))
                for i in range(steps):
                    tok = toks[:, prompt + i:prompt + i + 1]
                    if tag == "sharded":
                        tok = distribute_tree({"t": tok}, batch_sharding_tree(
                            {"t": tok}, mesh))["t"]
                    if i == 0:
                        if cfg.family == "ssm" and tag == "sharded":
                            # the same step from the reference's placement
                            ref = type(cache)(*(
                                t.clone().redistribute(mesh,
                                                       list(sh.placements))
                                for t, sh in zip(cache, cache_sharding(
                                    cache, mesh))))
                            got["rule_cache"] = seen_step(model, p, tok,
                                                          ref)[1]
                        lg, seen = seen_step(model, p, tok, cache)
                    else:
                        lg = model.decode(p, tok, cache)[0]
                    logits.append(_whole(lg))
            got[tag] = {"logits": logits, "seen": seen}
            if cfg.family == "ssm":
                got[tag]["state"] = (
                    cache.ssm.to_local().clone()
                    if isinstance(cache.ssm, DTensor) else cache.ssm.clone())
                if tag == "sharded":
                    got["placements"] = [str(q) for q in
                                         cache.ssm.placements]
        res[arch] = got
    return res


def _micro(mesh) -> dict:
    """``_split_micro`` of a [B, 3] batch whose rows sit on "data", into n
    microbatches, for (B, n) where each rank's rows split into n and
    where they do not: every microbatch whole and its placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.dist.sharding import batch_sharding_tree
    from repro_torch.train.loop import _split_micro

    res = {}
    for b, n in ((8, 2), (4, 4), (8, 4)):
        x = torch.arange(b * 3, dtype=torch.int32).reshape(b, 3)
        d = distribute_tensor(x, mesh, list(batch_sharding_tree(
            {"x": x}, mesh)["x"].placements))
        res[(b, n)] = (x, [(_whole(m), [str(p) for p in m.placements])
                           for m in _split_micro(d, n)])
    return res


def spawn_ranks(suite: str, inputs: dict, tmp: Path) -> list[dict]:
    """Start ``WORLD`` gloo ranks of ``torch_dist_ranks.py`` on ``inputs``
    and return each rank's readings."""
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite,
         str(r), str(WORLD), str(tmp / "store"), str(tmp / "inputs.npz"),
         str(tmp)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log) for r, (p, log)
           in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return [torch.load(tmp / f"{suite}-{r}.pt", weights_only=False)
            for r in range(WORLD)]


def main(suite: str, rank: int, world: int, store: str, inputs: str,
         out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with np.load(inputs) as f:
            arrays = {k: f[k] for k in f.files}
        fn = {"collectives": collectives, "dist": sharded_dist}[suite]
        result = fn(rank, world, arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"{suite}-{rank}.pt")


if __name__ == "__main__":
    suite, rank, world, store, inputs, out_dir = sys.argv[1:7]
    main(suite, int(rank), int(world), store, inputs, out_dir)
