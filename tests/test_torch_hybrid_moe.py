"""The hybrid_moe family (granite-4.0-h-small) on the CPU at its smoke size,
on seeded random weights, against the plain reference of the benchmark
(``perfbench/reference/hybrid_lm.py``, plain float32 torch written from
the published equations): a prefill's logits, prefill then decode through
the hybrid cache, a request spliced into a slot that served another, the
shared MLP as two experts, and granite-moe unchanged by the new fields."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.models.api import build_model as jbuild_model
from perfbench.lib import spec
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers import moe
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request

torch.set_num_threads(1)

ARCH = "granite-4.0-h-small"
REF = spec.load_module("reference", "hybrid_lm")


def _ref_cfg(cfg) -> dict:
    """The reference's configuration (granitemoehybrid's keys) of a port
    ``ModelConfig``."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "layer_types": list(cfg.layer_types),
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_expert,
        "shared_intermediate_size": cfg.n_shared_experts * cfg.d_expert,
        "num_experts_per_tok": cfg.top_k, "vocab_size": cfg.vocab,
        "mamba_expand": cfg.ssm_expand, "mamba_n_heads": cfg.n_ssm_heads,
        "mamba_d_head": cfg.ssm_head_dim, "mamba_n_groups": cfg.ssm_groups,
        "mamba_d_state": cfg.ssm_state, "mamba_d_conv": cfg.ssm_conv_width,
        "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling,
    }


@pytest.fixture(scope="module")
def smoke():
    """The smoke model in f32 and its params, with the norm scales, the
    conv bias and D moved off their initial constants."""
    cfg = smoke_config(ARCH).replace(dtype="float32")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(2**31 + 5)
    params = model.init(g, device="cpu")
    for tree, key in ((params["blocks"]["ln1"], "scale"),
                      (params["blocks"]["ln2"], "scale"),
                      (params["final_norm"], "scale"),
                      (params["mamba"], "norm_scale"),
                      (params["mamba"], "conv_b"),
                      (params["mamba"], "d_skip")):
        tree[key] = tree[key] + 0.1 * torch.randn(tree[key].shape,
                                                  generator=g)
    return model, params


def _tokens(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, smoke_config(ARCH).vocab, (n,), generator=g)


def test_the_registry_gives_the_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab) == (
        "hybrid_moe", 40, 4096, 100352)
    assert cfg.mamba_layers == tuple(i for i in range(40) if i % 10 != 5)
    assert cfg.attn_layers == (5, 15, 25, 35)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_) == (32, 8, 128)
    assert (cfg.d_inner, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_groups, cfg.conv_dim) == (8192, 128, 64, 128, 1, 8448)
    assert (cfg.n_experts, cfg.top_k, cfg.d_expert,
            cfg.n_shared_experts * cfg.d_expert) == (72, 10, 768, 1536)
    assert cfg.rope_theta == 0 and cfg.attention_multiplier == 1 / 128
    # 40 layers: 32.2B parameters, of which 8.8B are active a token
    assert 32.1e9 < cfg.param_count() < 32.3e9
    assert 8.7e9 < cfg.active_param_count() < 8.9e9
    small = smoke_config(ARCH)
    assert small.layer_types == ("mamba", "attention")
    assert small.n_layers == 2


def test_prefill_logits_match_the_reference(smoke):
    model, params = smoke
    seq = _tokens(40, 1)
    v = model.cfg.vocab
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": seq[None]})
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(40))
    assert float((got[0, :, :v] - want).abs().max()) < 1e-5
    assert float(want.std()) > 1e-2  # the comparison sees real logits
    low = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(40),
                     fp8=True)
    assert float((low - want).abs().max()) > 1e-3


def test_prefill_then_decode_through_the_hybrid_cache(smoke):
    """Prefill a prompt, then decode through the cache (K/V of the
    attention layer, state and conv tail of the Mamba2 layer): each row
    against the reference's whole-sequence forward."""
    model, params = smoke
    seq = _tokens(40, 2)
    v = model.cfg.vocab
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": seq[None, :21]}, 48)
        assert isinstance(cache, lm.HybridCache)
        assert cache.k.shape[0] == 1 and cache.ssm.shape[0] == 1
        assert cache.ssm.dtype == torch.float32
        rows = [lg[0, -1, :v]]
        for t in seq[21:]:
            lg, cache = model.decode(params, t.view(1, 1), cache)
            rows.append(lg[0, -1, :v])
    assert cache.length == 40
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(20, 40))
    assert float((torch.stack(rows) - want).abs().max()) < 1e-5


def _serve(model, params, reqs, n_slots):
    """Serves ``reqs`` through an engine over a kernel-level transfer
    engine on a private runtime (whose admission reads no counts another
    test left); returns each request's logits rows (its prefill's, then
    its decodes') by rid."""
    rows: dict[int, list] = {}
    order: list[int] = []  # the rids in the order the engine admits them
    eng = None

    def prefill(p, batch, s_max):
        out = model.prefill(p, batch, s_max)
        rows[order[len(rows)]] = [out[0][0, -1]]
        return out

    def decode(p, token, cache):
        out = model.decode(p, token, cache)
        for s, q in enumerate(eng.slots):
            if q is not None:
                rows[q.rid].append(out[0][s, -1])
        return out

    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(), device="cpu",
                              runtime=rt)
    eng = ContinuousBatchingEngine(
        dataclasses.replace(model, prefill=prefill, decode=decode), params,
        n_slots=n_slots, max_seq=64, transfer=transfer)
    try:
        for r in reqs:
            order.append(r.rid)
            assert eng.submit(r).admitted
        done = eng.run_to_completion()
    finally:
        eng.close()
        transfer.close()
        rt.close()
    return {q.rid: (q.tokens, torch.stack(rows[q.rid][:len(q.tokens)]))
            for q in done}


def test_a_spliced_slot_keeps_nothing_of_its_last_request(smoke):
    """Request 2 lands in the slot request 0 left (its K/V rows, state and
    conv tail overwritten whole, while the other slot decodes request 1);
    it serves what it serves alone in a fresh engine."""
    model, params = smoke

    def req(rid, n, seed, new):
        return Request(rid=rid, prompt=_tokens(n, seed).numpy().astype(
            np.int32), max_new_tokens=new)

    shared = _serve(model, params, [req(0, 30, 3, 6), req(1, 12, 4, 14),
                                    req(2, 19, 5, 8)], 2)
    alone = _serve(model, params, [req(2, 19, 5, 8)], 2)
    assert shared[2][0] == alone[2][0]
    assert float((shared[2][1] - alone[2][1]).abs().max()) < 1e-5


def test_two_shared_experts_are_one_mlp_of_twice_the_width():
    """The MoE's shared part with ``n_shared_experts = 2`` of width F (the
    gate columns of both, then the up columns) is one gated SiLU MLP of
    width 2F, and the sum of two gated MLPs of width F."""
    g = torch.Generator().manual_seed(7)
    d, f, t = 32, 12, 10
    p = moe.moe_params(g, d, 4, f, 2, torch.float64)
    x = torch.randn(t, d, generator=g, dtype=torch.float64)
    got = moe._shared_experts(p, x, torch.zeros(t, d, dtype=torch.float64))
    gate, up = p["ws_up"][:, :2 * f], p["ws_up"][:, 2 * f:]
    one = (torch.nn.functional.silu(x @ gate) * (x @ up)) @ p["ws_down"]
    two = sum((torch.nn.functional.silu(x @ gate[:, j * f:(j + 1) * f])
               * (x @ up[:, j * f:(j + 1) * f]))
              @ p["ws_down"][j * f:(j + 1) * f] for j in range(2))
    torch.testing.assert_close(got, one, rtol=0, atol=1e-12)
    torch.testing.assert_close(got, two, rtol=0, atol=1e-12)


def test_granite_moe_is_unchanged_by_the_new_fields():
    """granite-moe's smoke logits with the new fields at their defaults:
    equal to the JAX reference's, bitwise to the same config with those
    defaults written out, and bitwise to the same model run as hybrid_moe
    layers that are all attention (the attention stacked apart from the
    blocks): one layer and one loop serve both families."""
    import jax

    cfg = smoke_config("granite-moe-1b-a400m").replace(dtype="float32")
    jcfg = jregistry.smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    params = lm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24))
    want = np.asarray(jmodel.forward(jparams, {"tokens": tokens})[0])
    explicit = cfg.replace(layer_types=(), embedding_multiplier=1.0,
                           residual_multiplier=1.0, attention_multiplier=0.0,
                           logits_scaling=1.0, norm_eps=1e-6)
    hybrid = explicit.replace(family="hybrid_moe",
                              layer_types=("attention",) * cfg.n_layers)
    blocks = dict(params["blocks"])
    split = {**params, "blocks": blocks, "attn": blocks.pop("attn")}
    with torch.no_grad():
        got = build_model(cfg).forward(
            params, {"tokens": torch.from_numpy(tokens)})[0]
        again = build_model(explicit).forward(
            params, {"tokens": torch.from_numpy(tokens)})[0]
        as_hybrid = build_model(hybrid).forward(
            split, {"tokens": torch.from_numpy(tokens)})[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got, again)
    assert torch.equal(got, as_hybrid)


def test_the_attention_scale_reaches_the_cached_routes():
    """A scale from the config moves the unique and the blocks routes alike
    (the serving path's cache of 4,608 takes blocks)."""
    from repro_torch.models.layers import attention as att

    g = torch.Generator().manual_seed(9)
    q = torch.randn(2, 3, 4, 8, generator=g)
    k = torch.randn(2, 40, 2, 8, generator=g)
    v = torch.randn(2, 40, 2, 8, generator=g)
    kw = dict(q_offset=torch.tensor([10, 30]),
              kv_valid=torch.tensor([13, 33]))
    for scale in (None, 1 / 8, 0.5):
        uni = att.attention_unique(q, k, v, scale=scale, **kw)
        blk = att.attention_blocks(q, k, v, scale=scale, kv_chunk=16, **kw)
        torch.testing.assert_close(uni, blk, rtol=1e-5, atol=1e-5)
    default = att.attention_unique(q, k, v, **kw)
    torch.testing.assert_close(
        default, att.attention_unique(q, k, v, scale=8 ** -0.5, **kw))
    assert not torch.allclose(default,
                              att.attention_unique(q, k, v, scale=0.5, **kw))


@pytest.mark.parametrize("scale", [None, 1 / 128, 0.5])
def test_the_attention_scale_reaches_the_flash_route(scale):
    """With ``use_pallas`` and no cache the flash route takes a scale from
    the config (folded into q) and gives the plain route's output."""
    from repro_torch.models.layers import attention as att

    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 24, 4, 16, generator=g)
    k = torch.randn(2, 24, 2, 16, generator=g)
    v = torch.randn(2, 24, 2, 16, generator=g)
    kw = dict(rope_theta=0.0, window=0, kv_chunk=1024, blocks_threshold=4096,
              cache=None, positions=None, cross=False, causal=True,
              scale=scale)
    flash, _ = att._attend(q, k, v, use_pallas=True, **kw)
    plain, _ = att._attend(q, k, v, use_pallas=False, **kw)
    torch.testing.assert_close(flash, plain, rtol=1e-5, atol=1e-5)
