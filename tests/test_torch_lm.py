"""The decoder LM end to end on the CPU: configs, layers, the scoring
forward, prefill / decode / chunked prefill of the port, each held against
the reference package on the same params (``params_from_jax``) and inputs;
the dense family in detail, and the moe, vlm and audio families' models."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
import repro.models.config as jconfig
from repro.models import lm as jlm
from repro.models.api import build_model as jbuild_model
from repro.models.api import cross_entropy as jcross_entropy
from repro.models.layers import attention as jattn
from repro.models.layers.mlp import mlp_apply as jmlp_apply
from repro.models.layers.norm import layer_norm as jlayer_norm
from repro.models.layers.norm import rms_norm as jrms_norm
from repro.models.layers.rope import apply_rope as japply_rope
import repro_torch.configs.registry as registry
import repro_torch.models.config as config
from repro_torch.models import lm
from repro_torch.models.api import build_model, cross_entropy
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.mlp import mlp_apply
from repro_torch.models.layers.norm import layer_norm, rms_norm
from repro_torch.models.layers.rope import apply_rope

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

DENSE = ["qwen2.5-3b", "h2o-danube-1.8b", "stablelm-12b", "internlm2-20b"]
SSM = ["mamba2-780m", "zamba2-1.2b"]
NEW = ["seamless-m4t-medium", "pixtral-12b", "deepseek-moe-16b",
       "granite-moe-1b-a400m"]
ATOL = 1e-4


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---- configs ----------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + SSM)
def test_configs_match_reference(arch):
    for full in (True, False):
        get = "get_config" if full else "smoke_config"
        ours = getattr(registry, get)(arch)
        ref = getattr(jregistry, get)(arch)
        mine, theirs = dataclasses.asdict(ours), dataclasses.asdict(ref)
        assert {k: mine[k] for k in theirs} == theirs
        # the port's own fields (the hybrid_moe family's) at their defaults
        extra = {f.name: f.default for f in dataclasses.fields(ours)
                 if f.name not in theirs}
        assert {k: mine[k] for k in extra} == extra
        assert ours.param_count() == ref.param_count()
        assert ours.vocab_padded == ref.vocab_padded
    assert registry.get_config(arch, dtype="float32").dtype == "float32"


def test_qwen_full_width_shape():
    cfg = registry.get_config("qwen2.5-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_, cfg.d_ff, cfg.vocab_padded) == (
        36, 2048, 16, 2, 128, 11008, 152064)
    assert cfg.param_count() == 3_397_627_904


@pytest.mark.parametrize("arch", NEW)
def test_moe_vlm_audio_configs_match_reference_field_by_field(arch):
    for get in ("get_config", "smoke_config"):
        ours = getattr(registry, get)(arch)
        ref = getattr(jregistry, get)(arch)
        for f in dataclasses.fields(ref):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()
        assert ours.vocab_padded == ref.vocab_padded


def test_registry_lists_the_reference_archs():
    assert registry.ARCHS == jregistry.ARCHS == registry.list_archs()
    with pytest.raises(KeyError):
        registry.get_config("no-such-arch")


def test_shape_cells_match_reference():
    assert [dataclasses.astuple(c) for c in config.SHAPE_CELLS] == [
        dataclasses.astuple(c) for c in jconfig.SHAPE_CELLS]
    for arch in DENSE:
        for ours, ref in zip(config.SHAPE_CELLS, jconfig.SHAPE_CELLS):
            assert (config.cell_applicable(registry.get_config(arch), ours)
                    == jconfig.cell_applicable(jregistry.get_config(arch),
                                               ref))


def _family_batch(cfg, b, s, seed=0):
    """numpy batch of ``cfg``'s family: tokens and labels, and the vlm
    family's patch embeddings or the audio family's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "pixtral-12b",
                                  "seamless-m4t-medium"],
                         ids=["moe", "vlm", "audio"])
def test_moe_vlm_audio_models_build_and_run(arch):
    """Each family builds from its smoke config, draws its own params on
    the CPU and runs forward, loss, prefill and decode: shapes right,
    values finite, the moe family's router loss positive."""
    cfg = registry.smoke_config(arch)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _family_batch(cfg, 2, 12).items()}
    logits, aux = m.forward(params, batch)
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    assert tuple(logits.shape) == (2, off + 12, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all())
    assert (float(aux) > 0) == (cfg.family == "moe")
    total, metrics = m.loss(params, batch)
    assert np.isfinite(float(total)) and np.isfinite(float(metrics["acc"]))
    pre = {k: v for k, v in batch.items() if k != "labels"}
    pl, cache = m.prefill(params, pre, off + 16)
    dl, cache = m.decode(params, batch["tokens"][:, :1], cache)
    assert tuple(dl.shape) == (2, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(pl).all() and torch.isfinite(dl).all())


# ---- layers -----------------------------------------------------------------

def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jrms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layer_norm(_t(x), _t(scale), _t(bias)).numpy(),
        np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias))), rtol=1e-5, atol=1e-5)
    out = rms_norm(_t(x).bfloat16(), _t(scale))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("per_slot", [False, True])
def test_rope_matches_reference(per_slot):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, 32)).astype(np.float32)
    pos = (np.array([[3, 4, 5, 6, 7, 8], [0, 1, 2, 3, 4, 5]], np.int32)
           if per_slot else np.arange(6, dtype=np.int32) + 10)
    ref = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    got = apply_rope(_t(x), _t(pos), 1e6).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["gated_silu", "gelu"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(2)
    width = 96 if kind == "gated_silu" else 48
    p = {"wi": rng.standard_normal((32, width)).astype(np.float32) * 0.2,
         "wo": rng.standard_normal((48, 32)).astype(np.float32) * 0.2}
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    ref = np.asarray(jmlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), kind))
    got = mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), kind).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, 2] = np.argmax(logits[1, 2])
    ce, acc = cross_entropy(_t(logits), _t(labels), 40)
    jce, jacc = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), 40)
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-6)


@pytest.mark.parametrize("length", ["int", "scalar_tensor", "per_slot",
                                    "clamped", "per_slot_past_end"])
def test_cache_write_matches_reference(length):
    rng = np.random.default_rng(4)
    dst = rng.standard_normal((3, 16, 2, 8)).astype(np.float32)
    new = rng.standard_normal((3, 4, 2, 8)).astype(np.float32)
    ln = {"int": 5, "scalar_tensor": np.int32(7), "clamped": 14,
          "per_slot": np.array([0, 3, 12], np.int32),
          # rows past S_max are dropped (F6), the rest written
          "per_slot_past_end": np.array([14, 16, 40], np.int32)}[length]
    ref = np.asarray(jattn._cache_write(jnp.asarray(dst), jnp.asarray(new),
                                        jnp.asarray(ln)))
    tdst = _t(dst)
    t_len = ln if isinstance(ln, int) else _t(ln)
    got = attn._cache_write(tdst, _t(new), t_len)
    assert got is tdst  # in place
    np.testing.assert_array_equal(got.numpy(), ref)


def _qkv(b, sq, skv, h, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("fn", ["attention_unique", "attention_blocks"])
@pytest.mark.parametrize("case", ["scalar", "per_slot", "window_offset"])
def test_attention_paths_match_reference(fn, case):
    q, k, v = _qkv(3, 2, 40, 4, 2, 16, seed=5)
    kw = {"scalar": dict(q_offset=20, kv_valid=22),
          "per_slot": dict(q_offset=np.array([5, 17, 30], np.int32),
                           kv_valid=np.array([7, 19, 32], np.int32)),
          "window_offset": dict(q_offset=30, kv_valid=32, kv_offset=8,
                                window=12)}[case]
    extra = {"kv_chunk": 16} if fn == "attention_blocks" else {}
    ref = np.asarray(getattr(jattn, fn)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{kk: (jnp.asarray(vv) if isinstance(vv, np.ndarray) else vv)
           for kk, vv in kw.items()}, **extra))
    got = getattr(attn, fn)(
        _t(q), _t(k), _t(v),
        **{kk: (_t(vv) if isinstance(vv, np.ndarray) else vv)
           for kk, vv in kw.items()}, **extra).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_attention_blocks_padding_matches_unique():
    # 40 keys in chunks of 16: the ragged tail is padded and masked
    q, k, v = _qkv(2, 40, 40, 4, 2, 16, seed=6)
    ref = np.asarray(jattn.attention_blocks(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_chunk=16,
        window=10))
    got = attn.attention_blocks(_t(q), _t(k), _t(v), kv_chunk=16, window=10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(),
        attn.attention_unique(_t(q), _t(k), _t(v), window=10).numpy(),
        rtol=1e-5, atol=1e-5)


# ---- the model --------------------------------------------------------------

def _pair(arch, **over):
    """(reference model, port model, reference params, port params): the
    reference's init, with biases and norm params perturbed so that every
    parameter takes part, carried over by ``params_from_jax``."""
    over = {"dtype": "float32", **over}
    jcfg = jregistry.smoke_config(arch).replace(**over)
    cfg = registry.smoke_config(arch).replace(**over)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pnp = jax.tree_util.tree_map(np.array, jp)
    rng = np.random.default_rng(7)
    for blk in ("ln1", "ln2"):
        for k in pnp["blocks"][blk]:
            pnp["blocks"][blk][k] += (0.1 * rng.standard_normal(
                pnp["blocks"][blk][k].shape)).astype(np.float32)
    for k in ("bq", "bk", "bv"):
        if k in pnp["blocks"]["attn"]:
            pnp["blocks"]["attn"][k] = (0.1 * rng.standard_normal(
                pnp["blocks"]["attn"][k].shape)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    return jm, m, jp, lm.params_from_jax(pnp, "cpu")


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


MODES = {
    "jnp": ({}, 64),
    "flash": ({"use_pallas_attention": True, "pallas_interpret": True}, 64),
    # blocks forced: threshold below S, KV length not a chunk multiple
    "blocks": ({"attn_blocks_threshold": 16, "attn_kv_chunk": 40}, 48),
}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch,over", [
    ("qwen2.5-3b", {}), ("h2o-danube-1.8b", {"sliding_window": 32}),
    ("stablelm-12b", {})], ids=["qwen", "danube-swa32", "stablelm-ln"])
def test_forward_and_loss_match_reference(arch, over, mode):
    extra, s = MODES[mode]
    jm, m, jp, tp = _pair(arch, **over, **extra)
    toks = _tokens(jm.cfg.vocab, 2, s)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks), "labels": _t(labels)}
    jl, _ = jax.jit(jm.forward)(jp, jb)
    tl, aux = m.forward(tp, tb)
    assert tl.shape == (2, s, m.cfg.vocab_padded) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    (jtot, jmet), (ttot, tmet) = jax.jit(jm.loss)(jp, jb), m.loss(tp, tb)
    np.testing.assert_allclose(float(ttot), float(jtot), atol=ATOL)
    np.testing.assert_allclose(float(tmet["acc"]), float(jmet["acc"]))
    assert float(aux) == 0.0


def test_flash_dispatch_only_without_cache(monkeypatch):
    """use_pallas sends the scoring forward (no cache) through the flash
    wrapper once a layer, and never the cache paths, as the reference."""
    import repro_torch.kernels.flash_attention.ops as ops
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, m, _, tp = _pair("qwen2.5-3b", use_pallas_attention=True)
    toks = _t(_tokens(m.cfg.vocab, 2, 16))
    m.forward(tp, {"tokens": toks})
    assert len(calls) == m.cfg.n_layers
    _, cache = m.prefill(tp, {"tokens": toks}, 32)
    m.decode(tp, toks[:, :1], cache)
    assert len(calls) == m.cfg.n_layers


def test_params_from_jax_keeps_layout():
    jm, m, jp, tp = _pair("qwen2.5-3b")
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_shapes_match_reference(dtype):
    cfg = registry.smoke_config("stablelm-12b").replace(dtype=dtype)
    jcfg = jregistry.smoke_config("stablelm-12b").replace(dtype=dtype)
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[1] == str(leaf.dtype)
    again = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(got["blocks"]["attn"]["wq"],
                       again["blocks"]["attn"]["wq"])
    assert not torch.equal(got["blocks"]["attn"]["wq"][0],
                           got["blocks"]["attn"]["wq"][1])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    m = build_model(registry.smoke_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        m.init_cache(1, 8)


@pytest.mark.parametrize("arch,over", [
    ("qwen2.5-3b", {}), ("stablelm-12b", {}),
    ("h2o-danube-1.8b", {"sliding_window": 32})],
    ids=["qwen", "stablelm-ln", "danube-swa32"])
def test_prefill_and_decode_match_reference(arch, over):
    jm, m, jp, tp = _pair(arch, **over)
    b, s, s_max = 2, 12, 32
    toks = _tokens(jm.cfg.vocab, b, s + 3, seed=1)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, s_max))(
        jp, jnp.asarray(toks[:, :s]))
    tl, tc = m.prefill(tp, {"tokens": _t(toks[:, :s])}, s_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tc.length == s
    jdec = jax.jit(jm.decode)
    for i in range(3):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = m.decode(tp, _t(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=ATOL)
    assert tc.length == s + 3 == int(jc.length[0])


def test_prefill_chunked_matches_reference():
    jm, m, jp, tp = _pair("qwen2.5-3b")
    toks = _tokens(jm.cfg.vocab, 2, 24, seed=2)
    jl, jc = jlm.prefill_chunked(jm.cfg, jp, jnp.asarray(toks), 32, chunk=8)
    tl, tc = lm.prefill_chunked(m.cfg, tp, _t(toks), 32, chunk=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=ATOL)
    # Model.prefill takes the chunked path when prefill_chunk divides S
    _, mc, _, tpc = _pair("qwen2.5-3b", prefill_chunk=8)
    tl2, _ = mc.prefill(tpc, {"tokens": _t(toks)}, 32)
    np.testing.assert_allclose(tl2.numpy(), tl.numpy(), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="divisible"):
        lm.prefill_chunked(m.cfg, tp, _t(toks[:, :20]), 32, chunk=8)


def test_swa_decode_sliced_cache_matches_reference():
    """tests/test_swa_decode.py's slice path (cache > 2 x window): the
    port's decode after prefill matches the reference's, and the full
    forward."""
    jm, m, jp, tp = _pair("h2o-danube-1.8b", sliding_window=32)
    b, s, s_max = 2, 100, 256
    toks = _tokens(jm.cfg.vocab, b, s, seed=3)
    full, _ = m.forward(tp, {"tokens": _t(toks)})
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, s_max))(
        jp, jnp.asarray(toks[:, :s - 1]))
    tl, tc = m.prefill(tp, {"tokens": _t(toks[:, :s - 1])}, s_max)
    jd, _ = jax.jit(jm.decode)(jp, jnp.asarray(toks[:, s - 1:]), jc)
    td, _ = m.decode(tp, _t(toks[:, s - 1:]), tc)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL, rtol=0)
    np.testing.assert_allclose(td[:, -1].numpy(), full[:, s - 1].numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(tl[:, -1].numpy(), full[:, s - 2].numpy(),
                               atol=1e-3)


def test_swa_decode_with_tensor_length_gathers_on_device():
    """A 0-d tensor cache length takes the gather path of the window slice
    (no host sync) and gives the int path's logits."""
    _, m, _, tp = _pair("h2o-danube-1.8b", sliding_window=32)
    toks = _t(_tokens(m.cfg.vocab, 1, 90, seed=4))
    _, c_int = m.prefill(tp, {"tokens": toks[:, :89]}, 256)
    _, c_ten = m.prefill(tp, {"tokens": toks[:, :89]}, 256)
    c_ten = c_ten._replace(length=torch.tensor(c_ten.length))
    l_int, c1 = m.decode(tp, toks[:, 89:], c_int)
    l_ten, c2 = m.decode(tp, toks[:, 89:], c_ten)
    torch.testing.assert_close(l_ten, l_int, rtol=0, atol=1e-6)
    assert c1.length == 90 and int(c2.length) == 90


def test_params_from_jax_carries_bf16():
    jcfg = jregistry.smoke_config("qwen2.5-3b")  # bfloat16, the default
    jp = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    tp = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"]["ln1"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["blocks"]["mlp"]["wi"].float().numpy(),
        np.asarray(jp["blocks"]["mlp"]["wi"], np.float32))


@pytest.mark.parametrize("tie", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_logits_from_hidden_matches_reference(dtype, tie):
    """The logits head on the CPU for bf16 and f32 params, tied or not:
    f32 logits from the reference's params, held against its
    ``preferred_element_type=float32`` einsum (bf16 products are exact in
    f32 on both sides; only the order of the f32 sums may differ)."""
    jcfg = jregistry.smoke_config("qwen2.5-3b").replace(
        dtype=dtype, tie_embeddings=tie)
    cfg = registry.smoke_config("qwen2.5-3b").replace(
        dtype=dtype, tie_embeddings=tie)
    jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    tp = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jlm.logits_from_hidden(jcfg, jp, jx))
    got = lm.logits_from_hidden(cfg, tp, tx)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_cache", [False, True])
def test_cross_attention_matches_reference(with_cache):
    """attn_apply with encoder states (xk): no RoPE, not causal; with a
    precomputed encoder cache it attends over the cache's valid prefix."""
    rng = np.random.default_rng(8)
    d, h, hkv, dh = 32, 4, 2, 8
    p = {k: (rng.standard_normal(shape) * 0.2).astype(np.float32)
         for k, shape in (("wq", (d, h * dh)), ("wk", (d, hkv * dh)),
                          ("wv", (d, hkv * dh)), ("wo", (h * dh, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    xk = rng.standard_normal((2, 9, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=hkv, head_dim=dh, rope_theta=1e4)
    jkw, tkw = {}, {}
    if with_cache:
        ck = rng.standard_normal((2, 12, hkv, dh)).astype(np.float32)
        cv = rng.standard_normal((2, 12, hkv, dh)).astype(np.float32)
        jkw["cache"] = jattn.KVCache(jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(7, jnp.int32))
        tkw["cache"] = attn.KVCache(_t(ck), _t(cv), 7)
    ref, jc = jattn.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), xk=jnp.asarray(xk), **kw,
                               **jkw)
    got, tc = attn.attn_apply({k: _t(v) for k, v in p.items()}, _t(x),
                              xk=_t(xk), **kw, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (tc is None) == (jc is None)


# ---- the moe, vlm and audio families against the reference -----------------

@pytest.mark.parametrize("arch", NEW)
def test_moe_vlm_audio_families_match_reference(arch):
    """Forward, loss, and prefill(S-1) + decode(1) of each family's smoke
    config against the reference's on the same params and inputs, and
    against the port's own forward at the same positions (the reference's
    tests/test_models.py limits, rtol = atol = 2e-4; moe at capacity
    factor 64, as there)."""
    kw = {"capacity_factor": 64.0} if "moe" in arch else {}
    jcfg = jregistry.smoke_config(arch).replace(dtype="float32", **kw)
    cfg = registry.smoke_config(arch).replace(dtype="float32", **kw)
    jm, m = jbuild_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = lm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    b, s = 2, 24
    off = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    batch = _family_batch(cfg, b, s, seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    jl, jaux = jm.forward(jp, jb)
    tl, aux = m.forward(tp, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    (jtot, jmet), (ttot, tmet) = jm.loss(jp, jb), m.loss(tp, tb)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=2e-4, atol=2e-4)
    pre = {k: v for k, v in tb.items() if k != "labels"}
    pre["tokens"] = tb["tokens"][:, :s - 1]
    jpre = {k: v for k, v in jb.items() if k != "labels"}
    jpre["tokens"] = jb["tokens"][:, :s - 1]
    jpl, jc = jm.prefill(jp, jpre, off + s + 8)
    pl, cache = m.prefill(tp, pre, off + s + 8)
    jdl, _ = jm.decode(jp, jb["tokens"][:, s - 1:], jc)
    dl, _ = m.decode(tp, tb["tokens"][:, s - 1:], cache)
    for got, ref, pos in ((pl, jpl, off + s - 2), (dl, jdl, off + s - 1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got[:, -1].numpy(), tl[:, pos].numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_vlm_loss_is_over_the_text_positions():
    _, m, _, tp = _pair("pixtral-12b")
    batch = {k: _t(v) for k, v in _family_batch(m.cfg, 2, 10, 3).items()}
    logits, _ = m.forward(tp, batch)
    ce, _ = cross_entropy(logits[:, m.cfg.n_prefix_tokens:], batch["labels"],
                          m.cfg.vocab_padded)
    np.testing.assert_allclose(float(m.loss(tp, batch)[1]["loss"]),
                               float(ce), rtol=1e-6)
    # the patch embeddings reach the text positions
    other = dict(batch, patch_embeds=batch["patch_embeds"] + 1.0)
    assert not torch.allclose(m.forward(tp, other)[0][:, -1], logits[:, -1])


def test_launch_serve_vlm_sizes_max_seq_with_the_prefix(monkeypatch):
    """Divergence from the reference's launcher: for the vlm family the
    cache holds the patch positions too, so max_seq is prompt + new + 8 +
    n_prefix_tokens; the patch embeddings ride the prompt's TX."""
    from repro_torch.launch import serve as launch_serve

    seen = {}

    class Recording(launch_serve.ServingEngine):
        def generate(self, prompts, max_new_tokens=32, extra_inputs=None,
                     **kw):
            seen["max_seq"] = self.cfg.max_seq
            seen["extra"] = {k: v.shape for k, v in extra_inputs.items()}
            return super().generate(prompts, max_new_tokens, extra_inputs,
                                    **kw)

    monkeypatch.setattr(launch_serve, "ServingEngine", Recording)
    cfg = registry.smoke_config("pixtral-12b")
    res = launch_serve.main(["--device", "cpu", "--arch", "pixtral-12b",
                             "--batch", "2", "--prompt-len", "6",
                             "--new-tokens", "3"])
    assert seen["max_seq"] == 6 + 3 + 8 + cfg.n_prefix_tokens
    assert seen["extra"] == {
        "patch_embeds": (2, cfg.n_prefix_tokens, cfg.d_model)}
    assert len(res) == 2 and res[0].tokens.shape == (3,)
