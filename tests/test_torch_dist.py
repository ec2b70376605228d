"""The port's distributed slice on the CPU against the reference:

- ``dist/elastic.py``: the reference's elastic cases through both packages;
- ``dist/sharding.py``: every leaf's ``.spec`` equal to the reference's
  rules (``_param_spec`` / ``_data_axes`` through its tree functions) for
  every arch's full-width params and AdamW state (shapes only, under
  ``FakeTensorMode``), the reference's input specs of each shape cell and
  the port's decode caches, on the (16, 16) and (2, 16, 16) sizes;
- ``launch/mesh.py``: the production meshes built in a subprocess under
  the ``fake`` process-group backend (world 256 / 512);
- on 4 gloo ranks started once for the module (``torch_dist_ranks.py``):
  the smoke qwen loss with params under ``param_sharding`` and the batch
  under ``batch_sharding_tree`` on a (2, 2) mesh against the loss on whole
  tensors (rtol 1e-5, as ``tests/test_sharding.py`` holds the reference),
  ``StagedPipeline(shardings=)`` staging each rank's shard under the three
  managements with and without an engine, every kernel wrapper
  refusing a ``DTensor``, and B = 1 decodes (h2o-danube's sliding
  window, mamba2's state) against whole tensors with each product's
  contraction split over "data" and the SSM state never gathered;
- ``decode_cache_sharding``: the reference's rule but for the SSM
  state's heads on "model";
- ``core/streaming.py:device_streamed_scan`` against the reference's with
  a stacked MLP and a bf16 -> f32 gather (f32, 1e-5), and against the
  port's ``stack_apply`` on the smoke qwen (bitwise).
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.configs.registry as jregistry
import repro.dist.elastic as jelastic
import repro.dist.sharding as jsharding
from repro.core.streaming import device_streamed_scan as j_scan
from repro.models.api import input_specs
from repro.models.config import SHAPE_CELLS, cell_applicable
import repro_torch.dist.elastic as elastic
from repro_torch.configs.registry import ARCHS, get_config, smoke_config
from repro_torch.core.streaming import device_streamed_scan
from repro_torch.dist import sharding
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.optim import adamw_init
from repro_torch.utils.pytree import tree_map
from torch_dist_ranks import (
    B1_CASES, FAMILIES, MOE_CASES, SEQ_CASES, WORLD, spawn_ranks)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SIZES = {"single_pod": {"data": 16, "model": 16},
         "multi_pod": {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------- elastic

def _shrink_keeps_model_axis(m):
    plan = m.shrink_mesh(384, model_parallel=16, multi_pod=True)
    assert plan.shape[plan.axis_names.index("model")] == 16
    assert plan.n_devices <= 384
    return plan.shape, plan.axis_names, plan.n_devices


def _shrink_single_pod(m):
    plan = m.shrink_mesh(240, model_parallel=16)
    assert plan.shape == (15, 16) and plan.axis_names == ("data", "model")
    return plan.shape, plan.axis_names


def _shrink_raises_when_model_axis_lost(m):
    with pytest.raises(ValueError) as e:
        m.shrink_mesh(8, model_parallel=16)
    return str(e.value)


def _reshard_data_only_change(m):
    old = m.shrink_mesh(512, model_parallel=16, multi_pod=True)
    new = m.shrink_mesh(384, model_parallel=16, multi_pod=True)
    plan = m.reshard_plan(256, old, new)
    assert plan["params_move"] is False  # TP width unchanged
    assert plan["grad_replicas"] == new.n_devices // 16
    return plan


def _reshard_detects_tp_change(m):
    plan = m.reshard_plan(256, m.MeshPlan((16, 16), ("data", "model")),
                          m.MeshPlan((32, 8), ("data", "model")))
    assert plan["params_move"] is True
    return plan


@pytest.mark.parametrize("case", [
    _shrink_keeps_model_axis, _shrink_single_pod,
    _shrink_raises_when_model_axis_lost, _reshard_data_only_change,
    _reshard_detects_tp_change], ids=lambda f: f.__name__.strip("_"))
def test_elastic_matches_reference(case):
    assert case(elastic) == case(jelastic)


def test_mesh_plan_validates_like_the_reference():
    for m in (elastic, jelastic):
        with pytest.raises(ValueError, match="align"):
            m.MeshPlan((2, 2), ("data",))
        with pytest.raises(ValueError, match=">= 1"):
            m.shrink_mesh(16, model_parallel=0)


# ----------------------------------------------------------- sharding rules

@pytest.fixture(scope="module")
def abstract_trees():
    """Each arch's full-width params, AdamW state and decode caches, as
    fake tensors (shapes and dtypes, no storage), built once."""
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = build_model(cfg)
        with FakeTensorMode():
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            opt = adamw_init(params)
            caches = {}
            jcfg = jregistry.get_config(arch)
            for cell in SHAPE_CELLS:
                if cell.kind == "decode" and cell_applicable(jcfg, cell)[0]:
                    caches[cell.name] = model.init_cache(
                        cell.global_batch, cell.seq_len, device="cpu")
        out[arch] = params, opt, caches
    return out


def _reference_specs(fn, tree, sizes: dict, monkeypatch) -> list:
    """The reference's tree function over ``tree``'s leaf shapes on a
    mesh of ``sizes``: its ``_named`` gives back the PartitionSpec."""
    monkeypatch.setattr(jsharding, "_named", lambda mesh, spec: spec)
    mesh = SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values())))
    shapes = jax.tree.map(lambda leaf: jax.ShapeDtypeStruct(
        tuple(getattr(leaf, "shape", ())), jnp.float32), tree)
    return [tuple(p) for p in jax.tree.leaves(fn(shapes, mesh))]


def _port_specs(fn, tree, sizes: dict) -> list:
    shardings = fn(tree, sizes)
    leaves = jax.tree.leaves(shardings)
    for sh in leaves:  # placements follow the spec, mesh dim by mesh dim
        for name, pl in zip(sizes, sh.placements):
            dims = [d for d, s in enumerate(sh.spec)
                    if s == name or (isinstance(s, tuple) and name in s)]
            assert (pl.is_shard() and pl.dim == dims[0]) if dims else (
                pl.is_replicate()), (sh, name)
    return [sh.spec for sh in leaves]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_specs_match_reference(arch, size, abstract_trees,
                                        monkeypatch):
    sizes = SIZES[size]
    params, opt, caches = abstract_trees[arch]
    checks = [("param_sharding", params), ("opt_state_sharding", opt)]
    for cell in SHAPE_CELLS:
        cfg = jregistry.get_config(arch)
        if cell_applicable(cfg, cell)[0]:
            checks.append(("batch_sharding_tree", input_specs(cfg, cell)))
    checks += [("cache_sharding", c) for c in caches.values()]
    n_sharded = 0
    for name, tree in checks:
        got = _port_specs(getattr(sharding, name), tree, sizes)
        want = _reference_specs(getattr(jsharding, name), tree, sizes,
                                monkeypatch)
        assert got == want, name
        n_sharded += sum(any(s is not None for s in spec) for spec in got)
    assert n_sharded > 0


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_sharding_puts_the_ssm_heads_on_model(arch, size,
                                                          abstract_trees):
    """The port's decode-cache placements are the reference's rule
    (``cache_sharding``) for every leaf but an SSM state's running state
    [L, B, H, P, N], which also has its heads on "model" (H divides 16 for
    mamba2 and zamba2)."""
    sizes = SIZES[size]
    caches = abstract_trees[arch][2]
    for cache in caches.values():
        got = jax.tree.leaves(sharding.decode_cache_sharding(cache, sizes))
        want = jax.tree.leaves(sharding.cache_sharding(cache, sizes))
        leaves = jax.tree.leaves(cache)
        assert len(got) == len(want) == len(leaves)
        for g, w, leaf in zip(got, want, leaves):
            if isinstance(leaf, torch.Tensor) and leaf.dim() == 5 and (
                    leaf.dtype == torch.float32) and (
                    get_config(arch).family in ("ssm", "hybrid")):
                assert g.spec == (*w.spec[:2], "model", None, None)
                assert str(g.placements[-1]) == "S(2)"
            else:
                assert g == w


def test_two_mesh_dims_on_one_tensor_dim_are_shard_on_both():
    sh = sharding.batch_sharding_tree(
        {"tokens": torch.empty(64, 8)}, SIZES["multi_pod"])["tokens"]
    assert sh.spec == (("pod", "data"), None) and sh.mesh is None
    assert [str(p) for p in sh.placements] == ["S(0)", "S(0)", "R"]


def test_length_vector_and_scalars_replicate():
    cache = lm.KVCache(torch.empty(4, 32, 8, 2, 16), torch.empty(4, 32, 8,
                                                                 2, 16),
                       torch.empty(32, dtype=torch.int32))
    specs = sharding.cache_sharding(cache, SIZES["single_pod"])
    assert isinstance(specs, lm.KVCache)
    assert specs.k.spec == (None, "data", None, None, None)
    assert specs.length.spec == (None,)  # [B], where the reference's is [L]
    assert sharding.cache_sharding(
        lm.KVCache(cache.k, cache.v, 7), SIZES["single_pod"]).length.spec == ()


def test_distribute_tree_refuses_a_plan_without_a_mesh():
    sh = sharding.param_sharding({"w": torch.ones(16, 16)},
                                 SIZES["single_pod"])
    with pytest.raises(ValueError, match="no mesh"):
        sharding.distribute_tree({"w": torch.ones(16, 16)}, sh)


# ---------------------------------------------------------- production mesh

_MESH_CODE = r"""
import json, sys
import torch.distributed as dist
import repro_torch.launch.mesh as m
from repro_torch.dist.sharding import param_sharding
out = {"pg_after_import": dist.is_initialized()}
for fn in (m.make_production_mesh, m.make_local_mesh):
    try:
        fn(device_type="cpu")
    except RuntimeError as e:
        out.setdefault("no_pg", []).append(str(e))
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch
for world, mp in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    mesh = m.make_production_mesh(multi_pod=mp, device_type="cpu")
    try:
        m.make_production_mesh(multi_pod=not mp, device_type="cpu")
    except ValueError as e:
        wrong = str(e)
    sh = param_sharding({"w": torch.empty(2048, 11008),
                         "b": torch.empty(3)}, mesh)
    out[str(world)] = {
        "shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
        "device_type": mesh.device_type,
        "coordinate": mesh.get_coordinate(), "wrong_size": wrong,
        "w": [str(p) for p in sh["w"].placements],
        "b": [str(p) for p in sh["b"].placements],
        "local": list(m.make_local_mesh(16, device_type="cpu").shape)}
    dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def production_meshes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _MESH_CODE],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_mesh_module_touches_no_process_group(production_meshes):
    assert production_meshes["pg_after_import"] is False
    assert len(production_meshes["no_pg"]) == 2
    assert all("init_process_group" in e for e in production_meshes["no_pg"])


@pytest.mark.parametrize("world,shape,names", [
    ("256", [16, 16], ["data", "model"]),
    ("512", [2, 16, 16], ["pod", "data", "model"])])
def test_production_mesh_under_the_fake_backend(production_meshes, world,
                                                shape, names):
    got = production_meshes[world]
    assert got["shape"] == shape and got["names"] == names
    assert got["device_type"] == "cpu"
    assert got["coordinate"] == ([0, 3] if world == "256" else [0, 0, 3])
    assert "needs" in got["wrong_size"]
    # the trailing dim on the model axis; a leaf it does not divide
    # replicates
    assert got["w"] == ["R"] * (len(shape) - 1) + ["S(1)"]
    assert got["b"] == ["R"] * len(shape)
    assert got["local"] == [int(world) // 16, 16]


# ------------------------------------------------- 4 gloo ranks, (2, 2) mesh

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
    inputs = {"tokens": toks,
              "labels": np.roll(toks, -1, axis=1).astype(np.int32)}
    return spawn_ranks("dist", inputs, tmp_path_factory.mktemp("dist"))


def test_sharded_loss_matches_the_unsharded_loss(ranks):
    for res in ranks:
        assert res["mesh"] == ((2, 2), ("data", "model"), "cpu")
        # the rules did shard the model: most leaves split over 2
        assert res["params_sharded"] >= res["params_leaves"] // 2
        np.testing.assert_allclose(res["loss_sharded"], res["loss_single"],
                                   rtol=1e-5)
    assert len({res["loss_single"] for res in ranks}) == 1


@pytest.mark.parametrize("arch", FAMILIES)
def test_each_family_sharded_matches_whole_tensors(ranks, arch):
    """The loss, a prefill's last logits and a decode step's logits of a
    smoke config of each other family, params / batch / caches as
    DTensors on the (2, 2) mesh, against the same on whole tensors (f32,
    rtol 1e-5, the reference's limit for its sharded loss); and every
    gradient of the loss (rtol 1e-4, atol 1e-4 of the leaf's largest:
    the shards' partial sums are added in another order)."""
    for res in ranks:
        single, sharded = res["families"][arch]["single"], \
            res["families"][arch]["sharded"]
        np.testing.assert_allclose(sharded[0], single[0], rtol=1e-5)
        for got, want in zip(sharded[1:], single[1:]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        want, got = res["families"][arch]["grads"]
        assert len(got) == len(want)
        for g, w in zip(got, want):  # f32 sums in other orders
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())


def test_expert_sharding_takes_the_reference_sites(ranks):
    """``moe_ep_sharding`` on: the expert-major intermediates (``xe``,
    ``h``, ``ye``) come out ``Shard(0)`` on "model" and each gathered
    ``got`` ``Shard(0)`` on "data", a layer at a time (2 layers, top-2),
    while the loss stays within 1e-5 of the whole-tensor loss (above)."""
    sites = ranks[0]["families"]["granite-moe-1b-a400m"]["sites"]
    ep = ("model", None, None)
    layer = [(ep, ["R", "S(0)"])] * 3 + [(("data", None), ["S(0)", "R"])] * 2
    # per layer: xe, h, ye in the dispatch / expert products, then one got
    # per k-slot; in the prefill and the decode step too (3 passes)
    assert sites == layer * 2 * 3, sites


def test_sharded_train_step_matches_whole_tensors(ranks):
    """One AdamW step of the smoke qwen with params, AdamW state and batch
    as DTensors on the (2, 2) mesh: the loss, the gradient norm and every
    updated leaf within f32 reach of the step on whole tensors (rtol
    1e-5), with 2 microbatches and with 4 (a rank's 2 rows do not split
    into 4: F9); microbatch i is the global rows [i B / n, (i + 1) B / n)
    either way, as the reference's reshape splits them."""
    for res in ranks:
        for n in (2, 4):
            single, sharded = res["train_step"][n]["single"], \
                res["train_step"][n]["sharded"]
            np.testing.assert_allclose(sharded[0], single[0], rtol=1e-5)
            np.testing.assert_allclose(sharded[1], single[1], rtol=1e-5)
            assert len(sharded[2]) == len(single[2])
            for got, want in zip(sharded[2], single[2]):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,n", [(8, 2), (4, 4), (8, 4)])
def test_microbatches_are_global_row_blocks(ranks, b, n):
    """``_split_micro`` of a DTensor batch gives ``x.reshape(n, B / n,
    ...)[i]``, where a rank's rows split into n and where they do not
    (4 rows in 4, 2 a rank: F9), each microbatch placed by the batch rule
    for its own row count (1 row: replicated)."""
    for res in ranks:
        x, micro = res["micro"][(b, n)]
        assert len(micro) == n
        want_pl = ["S(0)", "R"] if (b // n) % 2 == 0 else ["R", "R"]
        for i, (m, pl) in enumerate(micro):
            assert torch.equal(m, x.reshape(n, b // n, 3)[i])
            assert pl == want_pl


@pytest.mark.parametrize("case", MOE_CASES, ids=lambda c: "-".join(
    str(v) for v in c))
def test_expert_parallel_moe_matches_whole_tensors(ranks, case):
    """The expert-parallel MoE layer (tokens' rows on "data", experts on
    "model") against the same layer on whole tensors: every rank's seats
    (``keep``, the slots) its block of the whole seats and ``f_e`` /
    ``dropped`` the whole ones, exactly, capacity drops included; granite's
    output equal (atol 0, f32 and bf16; its k-slots sum in the reference's
    order), deepseek's within rtol 1e-5 (its shared experts sum over the
    "model" shards); aux within rtol 1e-6 (a mean of probabilities summed
    over the ranks); in f32 every gradient within rtol 1e-5 of the leaf's
    largest."""
    arch, dt, cf, ep = case
    for rank, res in enumerate(ranks):
        got = res["moe_layer"][case]
        whole, sharded = got["whole"], got["sharded"]
        top_k = whole["seats"]["keep"].numel() // 128  # 128 tokens
        block = slice((rank // 2) * 64, (rank // 2 + 1) * 64)  # its rows
        for k in ("keep", "slot"):
            want = whole["seats"][k].reshape(top_k, 128)[:, block]
            assert torch.equal(sharded["seats"][k].reshape(top_k, 64),
                               want), k
        for k in ("f_e", "dropped"):
            assert torch.equal(sharded["seats"][k], whole["seats"][k]), k
        assert sharded["dropped"] == whole["dropped"]
        if cf == 0.5:
            assert whole["dropped"] > 0.1  # seats were dropped
        if arch.startswith("granite"):
            assert torch.equal(sharded["out"], whole["out"])
        else:
            np.testing.assert_allclose(sharded["out"].float().numpy(),
                                       whole["out"].float().numpy(),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(sharded["aux"], whole["aux"], rtol=1e-6)
        if whole["grads"] is not None:
            assert sorted(sharded["grads"]) == sorted(whole["grads"])
            for k, w in whole["grads"].items():
                np.testing.assert_allclose(
                    sharded["grads"][k].numpy(), w.numpy(), rtol=1e-5,
                    atol=1e-5 * float(w.abs().max()), err_msg=k)


@pytest.mark.parametrize("case", [c[0] for c in SEQ_CASES])
def test_attention_reads_a_sequence_sharded_cache_where_it_lies(ranks,
                                                               case):
    """Attention against a [B, 32, Hkv, Dh] cache the rules shard 2 x 16
    on its sequence: each rank attends its slice for every row and the
    slices merge their log-sum-exp (output within rtol 1e-5 of the whole
    cache's); the new K/V land only in the slice that holds each row's
    position, so each rank's cache shard is bitwise the whole cache's
    slice after the write (a prompt from 0, positions 15 and 16 on either
    side of the slices' boundary, a write across it, a 0-d length,
    per-slot lengths in different slices and past the end)."""
    for rank, res in enumerate(ranks):
        got = res["seq_cache"][case]
        assert got["placements"] == ["S(1)", "R"]
        want, out = got["out"]
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)
        cols = slice((rank // 2) * 16, (rank // 2 + 1) * 16)
        for shard, whole in got["shards"]:
            assert torch.equal(shard, whole[:, cols])
        w_len, s_len = got["length"]
        assert torch.equal(torch.as_tensor(s_len), torch.as_tensor(w_len))


def test_hybrid_decodes_across_the_cache_slices(ranks):
    """zamba2 (smoke, f32) with its one-layer caches sharded 2 x 16 on the
    sequence by the rules: a 15-token prompt, then decode steps at
    positions 15 and 16 (the last column of rank 0's slice, the first of
    rank 1's); every step's logits within the families' limit of the
    whole tensors' (rtol 1e-5, atol 1e-5), every cache's K shard the
    whole K's slice within f32 reach of the projections (1e-5)."""
    for rank, res in enumerate(ranks):
        whole, sharded = res["hybrid_steps"]["whole"], \
            res["hybrid_steps"]["sharded"]
        assert all(pl == ["S(1)", "R"] for pl in sharded["placements"])
        assert len(sharded["logits"]) == 3
        for got, want in zip(sharded["logits"], whole["logits"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5)
        cols = slice((rank // 2) * 16, (rank // 2 + 1) * 16)
        for got, want in zip(sharded["k"], whole["k"]):
            np.testing.assert_allclose(got.numpy(), want[:, cols].numpy(),
                                       rtol=1e-5, atol=1e-5)
            assert not got[:, 17 - cols.start:].any() if cols.start else (
                got[:, 15].any())


@pytest.mark.parametrize("arch", [c[0] for c in B1_CASES])
def test_b1_decode_matches_whole_tensors(ranks, arch):
    """A B = 1 prompt and decode steps (h2o-danube's smoke window slicing
    the cache read; three mamba2 steps) over DTensors on the (2, 2) mesh,
    where the batch rule leaves the rows replicated on "data": every
    logit within the families' limit of the whole tensors' (f32, rtol
    1e-5, atol 1e-5)."""
    for res in ranks:
        got = res["b1_decode"][arch]
        whole, sharded = got["whole"]["logits"], got["sharded"]["logits"]
        assert len(sharded) == len(whole) == 1 + dict(
            (c[0], c[3]) for c in B1_CASES)[arch]
        for g, w in zip(sharded, whole):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", [c[0] for c in B1_CASES])
def test_b1_decode_splits_each_contraction_over_data(ranks, arch):
    """A B = 1 decode step's products on rank 0 of the (2, 2) mesh, under
    ``OpCost``: each product of the step on whole tensors [1, K] x [K, N]
    is [1, K/2] x [K/2, N/2] here (its contraction over "data", its
    columns over "model": a quarter of its FLOPs), and each product's
    partial sums are all-reduced over "data", one all-reduce a product."""
    for res in ranks[:1]:
        got = res["b1_decode"][arch]
        whole, sharded = got["whole"]["seen"], got["sharded"]["seen"]
        assert whole["products"] and whole["collectives"] == []
        assert sharded["products"] == [
            ((m, k // 2), (k // 2, n // 2))
            for (m, k), (_, n) in whole["products"]]
        reduced = [c for c in sharded["collectives"]
                   if c[:2] == ("all-reduce", "data")]
        assert len(reduced) == len(whole["products"])
        assert [c[2][-1] for c in reduced] == [
            n // 2 for _, (_, n) in whole["products"]]
        assert sharded["flops"] < whole["flops"] / 2


def test_ssm_state_stays_head_sharded_on_model(ranks):
    """Three mamba2 decode steps at B = 1 from the port's prefilled cache:
    the running state stays [Replicate(), Shard(2)] (heads on "model"),
    each rank's shard its heads of the whole state after the steps (f32,
    rtol 1e-5, atol 1e-5), and no collective moves the state (no result
    ends [.., P, N]); the same step from a cache on the reference's rule
    gathers the new heads over "model" once a layer."""
    cfg = smoke_config("mamba2-780m")
    pn = (cfg.ssm_head_dim, cfg.ssm_state)
    h_l = cfg.n_ssm_heads // 2
    for rank, res in enumerate(ranks):
        got = res["b1_decode"]["mamba2-780m"]
        assert got["placements"] == ["R", "S(2)"]
        h0 = (rank % 2) * h_l
        shard, whole = got["sharded"]["state"], got["whole"]["state"]
        assert shard.shape[2] == h_l
        np.testing.assert_allclose(shard.numpy(),
                                   whole[:, :, h0:h0 + h_l].numpy(),
                                   rtol=1e-5, atol=1e-5)

        def state_moves(seen):
            return [c for c in seen["collectives"] if c[2][-2:] == pn]

        assert state_moves(got["sharded"]["seen"]) == []
        assert state_moves(got["rule_cache"]) == [
            ("all-gather", "model", (2, h_l, *pn))] * cfg.n_layers


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_mixer_runs_its_heads_on_model(ranks, arch):
    """Under DTensors the SSM mixer takes half the heads a rank on the
    (2, 2) mesh (the families' loss, prefill, decode and gradients above
    hold the results), through the projection's column segments where a
    rank holds at least d_model tokens and through its gathered rows
    where it holds fewer (decode)."""
    cfg = smoke_config(arch)
    for res in ranks:
        calls = res["families"][arch]["mixers"]
        assert calls and {w for w, _ in calls} == {cfg.d_inner // 2}
        rows = {r for _, r in calls}
        assert min(rows) < cfg.d_model <= max(rows)


STAGINGS = [f"{m}/{e}" for m in ("polling", "scheduled", "interrupt")
            for e in ("plain", "engine")]


@pytest.mark.parametrize("staging", STAGINGS)
def test_sharded_staging_stages_each_ranks_shard(ranks, staging):
    host = ranks[0]["host"]
    half = [b // 2 for b in ranks[0]["host_bytes"]]  # data = 2
    for rank, res in enumerate(ranks):
        got, tx = res["staged"][staging]
        rows = slice((rank // 2) * 4, (rank // 2 + 1) * 4)  # its data row
        for step, batch in enumerate(got):
            assert sorted(batch) == sorted(host[step])
            local_bytes = 0
            for k, (kind, shape, placements, local, full) in batch.items():
                assert kind == "DTensor"
                assert shape == host[step][k].shape
                assert placements == ["S(0)", "R"]
                np.testing.assert_array_equal(local, host[step][k][rows])
                np.testing.assert_array_equal(full, host[step][k])
                local_bytes += local.nbytes
            assert local_bytes == half[step]
        if tx is not None:  # every TX through the engine is one shard
            assert tx and set(tx) == {half[0]}


@pytest.mark.parametrize("kernel", [
    "conv2d", "matmul_blocks", "matmul_unique", "flash", "ssd_intra_chunk",
    "ssd_state_pass"])
def test_kernel_wrappers_refuse_a_dtensor(ranks, kernel):
    for res in ranks:
        assert res[f"refuse/{kernel}"] and "DTensor" in res[f"refuse/{kernel}"]


# ---------------------------------------------------- device_streamed_scan

def test_device_streamed_scan_matches_reference():
    """A stacked MLP layer resting in bf16, gathered to f32 a layer."""
    rng = np.random.default_rng(11)
    n_layers, d, f = 5, 16, 32
    w1 = (rng.standard_normal((n_layers, d, f)) / d ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((n_layers, f, d)) / f ** 0.5).astype(np.float32)
    x = rng.standard_normal((3, d)).astype(np.float32)
    jparams = {"w1": jnp.asarray(w1, jnp.bfloat16),
               "w2": jnp.asarray(w2, jnp.bfloat16)}
    want = np.asarray(j_scan(
        lambda p, h: h + jax.nn.relu(h @ p["w1"]) @ p["w2"], jparams,
        jnp.asarray(x),
        gather_fn=lambda p: jax.tree.map(lambda t: t.astype(jnp.float32),
                                         p)))
    params = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.bfloat16) for k, v in jparams.items()}

    def layer(p, h):
        return h + torch.relu(h @ p["w1"]) @ p["w2"]

    got = device_streamed_scan(
        layer, params, torch.from_numpy(x),
        gather_fn=lambda p: tree_map(lambda t: t.float(), p))
    # XLA's and PyTorch's CPU GEMMs sum the dots in different orders: over
    # five residual layers that reaches ~4e-6 relative, so the limit is
    # the reference's own f32 rtol for its rings and sharded loss
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # and exactly the sequential loop
    h = torch.from_numpy(x)
    for i in range(n_layers):
        h = layer({k: v[i].float() for k, v in params.items()}, h)
    assert torch.equal(got, h)


def test_device_streamed_scan_is_bitwise_the_stack_scan():
    cfg = smoke_config("qwen2.5-3b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int64))
    positions = torch.arange(16)
    with torch.no_grad():
        x0 = lm.embed_tokens(cfg, params, tokens)
        want = lm.stack_apply(cfg, params, x0, None, positions)[0]
        got = device_streamed_scan(
            lambda p, h: lm.layer_apply(cfg, "attention", p, p["attn"], h,
                                        positions=positions)[0],
            params["blocks"], x0,
            gather_fn=lambda p: tree_map(torch.clone, p))
        plain = device_streamed_scan(
            lambda p, h: lm.layer_apply(cfg, "attention", p, p["attn"], h,
                                        positions=positions)[0],
            params["blocks"], x0)
    assert torch.equal(got, want) and torch.equal(plain, want)
