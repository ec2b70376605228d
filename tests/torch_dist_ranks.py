"""One rank of the port's multi-rank CPU tests (gloo), run as a script:

    python tests/torch_dist_ranks.py SUITE RANK WORLD STORE INPUTS OUT

``SUITE`` is ``collectives`` (the four rings on a ring of 4 and on the
model dim of a (2, 2) mesh, their hop counts and divisibility errors) or
``dist`` (the smoke qwen loss sharded on a (2, 2) mesh, the loss, prefill
and decode of a smoke config of each other family sharded the same way,
sharded batch staging under the three managements, the kernels' refusal of
DTensors).
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
    out["train_step"] = _train_step(mesh, inputs)

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
            got["sites"] = list(sites)
            with implicit_replication():
                got["grads"] = [
                    [whole(g) for g in tree_leaves(
                        value_and_grad(model, p, b)[2])]
                    for p, b in ((params, batch), (ps, bs))]
            res[arch] = got
    finally:
        moe._shard_experts = orig
    return res


def _train_step(mesh, inputs: dict) -> dict:
    """One AdamW step of the smoke qwen in f32 with 2 microbatches, on
    whole tensors and with params, AdamW state and batch as DTensors on
    ``mesh``: the loss, the gradient norm and every updated leaf."""
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
                                              n_microbatches=2))
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
