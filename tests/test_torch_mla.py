"""The mla family (DeepSeek-V2-Lite) on the CPU at its smoke size, on
seeded random weights, against the plain reference of the benchmark
(``perfbench/reference/mla_lm.py``, plain float32 torch written from the
published equations): a prefill's logits, a chunked prefill with a
ragged last chunk then decode steps through the latent cache, the
absorbed decode against the decompressed route, YaRN and sigma against
the published formulas, routing without renormalisation, the dense first
layer, a request spliced into a slot that served another, and the
existing MoE configurations unchanged by the new fields.

Tolerances: the port and the reference compute the same f32 arithmetic
in another order (blocks of keys, a cache, absorbed products), so they
agree to a few 1e-6 on logits of RMS ~1; 2e-5 leaves room for that and
is far below what one bf16 rounding of the activations moves (each test
that holds a route to it shows the bf16 run missing by more than 1e-3)."""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.models.api import build_model as jbuild_model
from perfbench.lib import spec
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.kernels.flash_attention.ops import flash_attention_dkv
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers import mla, moe
from repro_torch.models.layers.attention import attention
from repro_torch.models.layers.rope import rope_freqs, yarn_freqs, yarn_mscale
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request

torch.set_num_threads(1)

ARCH = "deepseek-v2-lite"
REF = spec.load_module("reference", "mla_lm")
TOL = 2e-5  # f32 against f32 in another order (module docstring)


def _ref_cfg(cfg) -> dict:
    """The reference's configuration (deepseek_v2's keys) of a port
    ``ModelConfig``."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim, "intermediate_size": cfg.d_ff,
        "moe_intermediate_size": cfg.d_expert,
        "n_shared_experts": cfg.n_shared_experts,
        "n_routed_experts": cfg.n_experts,
        "num_experts_per_tok": cfg.top_k,
        "first_k_dense_replace": cfg.first_k_dense,
        "norm_topk_prob": cfg.moe_renormalize, "routed_scaling_factor": 1,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
        "rope_scaling": {
            "type": "yarn", "factor": cfg.yarn_factor,
            "original_max_position_embeddings": cfg.yarn_original_max_pos,
            "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
            "mscale": cfg.yarn_mscale, "mscale_all_dim": cfg.yarn_mscale},
        "vocab_size": cfg.vocab,
    }


@pytest.fixture(scope="module")
def smoke():
    """The smoke model in f32 and its params, with every norm scale moved
    off 1."""
    cfg = smoke_config(ARCH).replace(dtype="float32")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(2**31 + 11)
    params = model.init(g, device="cpu")
    for tree in (params["blocks"]["ln1"], params["blocks"]["ln2"],
                 params["blocks"]["mla"]["kv_norm"], params["final_norm"]):
        tree["scale"] = tree["scale"] + 0.1 * torch.randn(
            tree["scale"].shape, generator=g)
    return model, params


def _tokens(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, smoke_config(ARCH).vocab, (n,), generator=g)


def _bf16(params):
    return {k: _bf16(v) if isinstance(v, dict) else
            (v.to(torch.bfloat16) if v.dtype == torch.float32
             and v.dim() > 1 and k != "router" else v)
            for k, v in params.items()}


def test_the_registry_gives_the_published_widths():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.vocab,
            cfg.n_heads) == ("mla", 27, 2048, 102400, 16)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
            cfg.v_head_dim, cfg.mla_rows) == (512, 128, 64, 128, 576)
    assert (cfg.first_k_dense, cfg.d_ff, cfg.n_experts, cfg.top_k,
            cfg.d_expert, cfg.n_shared_experts) == (1, 10944, 64, 6, 1408, 2)
    assert not cfg.moe_renormalize and not cfg.tie_embeddings
    assert cfg.prefill_chunk == 4096
    # prefill chunks attend on the flash kernel's two-width entry, and
    # their experts run over their own seats; decode steps (at most 32
    # slots) keep the padded buffer a CUDA graph replays
    assert cfg.use_pallas_attention and cfg.moe_ragged_tokens == 1
    # every token has a seat at every expert: dropless
    assert math.ceil(cfg.top_k * 4096 / cfg.n_experts
                     * cfg.capacity_factor) == 4096
    # 15.7B parameters, as published; a latent row of 1,152 bytes a layer
    assert 15.6e9 < cfg.param_count() < 15.8e9
    small = smoke_config(ARCH)
    assert small.family == "mla" and small.first_k_dense == 1
    assert small.n_layers - small.first_k_dense >= 2


def test_yarn_and_sigma_follow_the_published_formulas():
    """DeepSeek-V2's yarn_find_correction_range over the 32 frequencies of
    the 64 rope columns gives low 10 and high 23: below, RoPE's
    frequencies; above, RoPE's over 40; between, the linear ramp. sigma =
    (0.1 x 0.707 ln 40 + 1)^2 / sqrt(192) = 0.114721, and the cos/sin
    multiplier is 1 (mscale equals mscale_all_dim)."""
    cfg = get_config(ARCH)
    got = yarn_freqs(64, 10000.0, 40.0, 4096, 32.0, 1.0).double()
    j = torch.arange(32, dtype=torch.float64)
    base = 10000.0 ** (-2 * j / 64)
    ramp = ((j - 10) / 13).clamp(0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert torch.equal(got[:11], rope_freqs(64, 10000.0)[:11].double())
    torch.testing.assert_close(got[23:], base[23:] / 40, rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert yarn_mscale(40.0, 0.707) == pytest.approx(m, rel=1e-12)
    assert m == pytest.approx(1.26080, abs=1e-5)
    assert mla.mla_scale(cfg) == pytest.approx(m * m / math.sqrt(192),
                                               rel=1e-12)
    assert mla.mla_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    ref = _ref_cfg(cfg)
    assert REF.correction_range(ref) == (10, 23)
    torch.testing.assert_close(REF.inv_freq(ref, "cpu").double(), want,
                               rtol=1e-6, atol=0)


def test_prefill_logits_match_the_reference(smoke):
    model, params = smoke
    seq = _tokens(40, 1)
    v = model.cfg.vocab
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": seq[None]})
        low, _ = build_model(model.cfg.replace(dtype="bfloat16")).forward(
            _bf16(params), {"tokens": seq[None]})
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(40))
    assert float((got[0, :, :v] - want).abs().max()) < TOL
    assert float(want.std()) > 0.5  # the comparison sees real logits
    assert float((low[0, :, :v].float() - want).abs().max()) > 1e-3
    fp8 = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(40),
                     fp8=True)
    assert float((fp8 - want).abs().max()) > 1e-2


def test_ragged_chunked_prefill_then_decode_through_the_latent_cache(smoke):
    """A 37-token prompt prefills in chunks of 16, 16 and 5 (the smoke
    config's ``prefill_chunk``) into a ``LatentCache``, then 10 decode
    steps: every row against the reference's whole-sequence forward."""
    model, params = smoke
    assert model.cfg.prefill_chunk == 16
    seq = _tokens(48, 2)
    v = model.cfg.vocab
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": seq[None, :37]}, 64)
        assert isinstance(cache, mla.LatentCache) and cache.length == 37
        assert cache.kv.shape == (3, 1, 64, 40)
        assert not cache.kv[:, :, 37:].any()  # nothing past the prompt
        rows = [lg[0, -1, :v]]
        for t in seq[37:47]:
            lg, cache = model.decode(params, t.view(1, 1), cache)
            rows.append(lg[0, -1, :v])
    assert cache.length == 47
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(36, 47))
    assert float((torch.stack(rows) - want).abs().max()) < TOL


def test_a_prompt_the_chunk_divides_keeps_its_path(smoke):
    """32 tokens in chunks of 16: the same logits and cache as the chunked
    loop always gave, and the single-shot prefill's within f32 order."""
    model, params = smoke
    seq = _tokens(32, 3)[None]
    with torch.no_grad():
        a, ca = model.prefill(params, {"tokens": seq}, 40)
        b, cb = lm.prefill_chunked(model.cfg, params, seq, 40, chunk=16)
        c, cc = lm.prefill(model.cfg, params, seq, 40)
    assert torch.equal(a, b) and torch.equal(ca.kv, cb.kv)
    assert float((a - c).abs().max()) < TOL
    assert float((ca.kv - cc.kv).abs().max()) < TOL


def test_absorbed_decode_equals_the_decompressed_route(smoke):
    """One new token a slot against a cache of per-slot lengths: the
    absorbed products over the latent rows (q~ = q^C W_UK^T, o = (sum p c)
    W_UV) against K/V decompressed from the same rows and attended by the
    plain route."""
    model, params = smoke
    cfg = model.cfg
    p = {k: v[1] if isinstance(v, torch.Tensor) else
         {kk: vv[1] for kk, vv in v.items()}
         for k, v in params["blocks"]["mla"].items()}
    g = torch.Generator().manual_seed(4)
    b, s_max, h = 3, 30, cfg.n_heads
    rows = torch.randn(b, s_max, cfg.mla_rows, generator=g)
    length = torch.tensor([0, 11, 29])
    q_nope = torch.randn(b, h, cfg.qk_nope_head_dim, generator=g)
    q_pe = torch.randn(b, h, cfg.qk_rope_head_dim, generator=g)
    got = mla.absorbed(p, cfg, q_nope, q_pe, rows, length)
    k, v = mla.decompress(p, cfg, rows)
    want = attention(torch.cat([q_nope, q_pe], -1)[:, None], k, v,
                     q_offset=length, kv_valid=length + 1,
                     scale=mla.mla_scale(cfg))[:, 0]
    assert got.shape == (b, h, cfg.v_head_dim)
    assert float((got - want).abs().max()) < 1e-5
    low = mla.absorbed({kk: vv.bfloat16() if vv.dim() > 1 else vv
                        for kk, vv in p.items() if kk != "kv_norm"},
                       cfg, q_nope.bfloat16(), q_pe.bfloat16(),
                       rows.bfloat16(), length)
    assert float((low.float() - want).abs().max()) > 1e-3


def test_routing_without_renormalisation():
    """``renormalize=False`` weighs each chosen expert by its softmax
    probability over all experts (the k weights sum below 1), as the
    reference's MoE; the default renormalises, bitwise as before."""
    g = torch.Generator().manual_seed(8)
    d, e, f, k, t = 32, 8, 12, 3, 20
    p = moe.moe_params(g, d, e, f, 2, torch.float32)
    x = torch.randn(1, t, d, generator=g)
    cf = e / k  # dropless
    got, _ = moe.moe_apply(p, x, top_k=k, capacity_factor=cf,
                           renormalize=False)
    ref = {"num_experts_per_tok": k, "norm_topk_prob": False,
           "routed_scaling_factor": 1}
    want = REF._moe(ref, p, x[0], False)
    assert float((got[0] - want).abs().max()) < 1e-5
    renorm, _ = moe.moe_apply(p, x, top_k=k, capacity_factor=cf)
    again, _ = moe.moe_apply(p, x, top_k=k, capacity_factor=cf,
                             renormalize=True)
    assert torch.equal(renorm, again)
    want_renorm = REF._moe(dict(ref, norm_topk_prob=True), p, x[0], False)
    assert float((renorm[0] - want_renorm).abs().max()) < 1e-5
    assert float((renorm - got).abs().max()) > 1e-2
    _, w, _ = moe._gates(x[0], p["router"], k, renormalize=False)
    assert bool((w.sum(-1) < 1).all())


@pytest.mark.parametrize("dtype,cf,grad", [
    (torch.bfloat16, 8 / 3, False), (torch.bfloat16, 1.0, False),
    (torch.bfloat16, 8 / 3, True), (torch.float32, 8 / 3, False)])
def test_the_ragged_experts_give_the_padded_buffers_output(monkeypatch, dtype,
                                                           cf, grad):
    """From ``ragged_tokens`` on, a bf16 MoE whose capacity seats every
    token runs each expert over its own seats (grouped products): the
    padded [E, C, D] buffer's output within 1% of each row's RMS (the same
    bf16 products in GEMMs of other shapes; leaving out a token's first
    expert moves its row by over 10%), the same metrics. Where a seat can drop (capacity 8
    of 20 tokens), grad mode is on or the type is f32, the padded buffer
    serves, bitwise."""
    calls = []
    real = moe._ragged_experts
    monkeypatch.setattr(moe, "_ragged_experts",
                        lambda *a: calls.append(1) or real(*a))
    g = torch.Generator().manual_seed(9)
    d, e, f, k, t = 32, 8, 16, 3, 20
    p = moe.moe_params(g, d, e, f, 2, dtype)
    x = torch.randn(1, t, d, generator=g).to(dtype)
    with contextlib.nullcontext() if grad else torch.no_grad():
        want, wm = moe.moe_apply(p, x, top_k=k, capacity_factor=cf,
                                 renormalize=False)
        got, gm = moe.moe_apply(p, x, top_k=k, capacity_factor=cf,
                                renormalize=False, ragged_tokens=t)
        short, _ = moe.moe_apply(p, x, top_k=k, capacity_factor=cf,
                                 renormalize=False, ragged_tokens=t + 1)
    assert torch.equal(short, want)  # fewer tokens than ragged_tokens
    assert torch.equal(gm.aux_loss, wm.aux_loss)
    assert torch.equal(gm.dropped_frac, wm.dropped_frac)
    if cf < e / k or grad or dtype != torch.bfloat16:
        assert not calls and torch.equal(got, want)
        return
    assert len(calls) == 1
    want, got = want[0].float(), got[0].float()
    rms = want.pow(2).mean(-1).sqrt()
    assert bool(((got - want).pow(2).mean(-1).sqrt() <= 0.01 * rms).all())
    # token 0's first expert's product left out moves its row by far more
    e0 = int(moe._gates(x[0], p["router"], k, False)[2][0, 0])
    with torch.no_grad():
        lost, _ = moe.moe_apply(
            {**p, "we_down": p["we_down"].clone().index_fill_(
                0, torch.tensor([e0]), 0)}, x, top_k=k, capacity_factor=cf,
            renormalize=False, ragged_tokens=t)
    assert float((lost[0, 0].float() - want[0]).pow(2).mean().sqrt()) > (
        0.1 * float(rms[0]))


def test_the_two_width_flash_plain_version_is_the_plain_routes():
    """The flash kernel's two-width entry on CPU tensors (its plain
    version): q and K of 24, V of 16 read from a view into a wider tensor,
    13 queries after 20 cached keys, against the plain routes' causal
    attention at 1/sqrt(24), within f32 order; a query offset one short
    misses by far more."""
    g = torch.Generator().manual_seed(10)
    q = torch.randn(2, 13, 4, 24, generator=g)
    k = torch.randn(2, 33, 4, 24, generator=g)
    v = torch.randn(2, 33, 4, 40, generator=g)[..., 24:]
    got = flash_attention_dkv(q, k, v, q_offset=20)
    assert got.shape == (2, 13, 4, 16)
    want = attention(q, k, v, q_offset=20, scale=1 / math.sqrt(24),
                     blocks_threshold=1 << 20)
    assert float((got - want).abs().max()) < TOL
    off = flash_attention_dkv(q, k, v, q_offset=19)
    assert float((off - want).abs().max()) > 1e-2


def test_the_prefill_attends_alike_through_either_route(smoke):
    """A chunked prefill (16, 16, 5) with ``use_pallas_attention`` (the
    flash kernel's two-width entry, its plain version on the CPU) and
    through the plain routes: logits and latent cache within f32 order."""
    model, params = smoke
    assert model.cfg.use_pallas_attention
    plain = build_model(model.cfg.replace(use_pallas_attention=False))
    seq = _tokens(37, 12)[None]
    with torch.no_grad():
        a, ca = model.prefill(params, {"tokens": seq}, 48)
        b, cb = plain.prefill(params, {"tokens": seq}, 48)
    assert float((a - b).abs().max()) < TOL
    assert float((ca.kv - cb.kv).abs().max()) < TOL


def test_the_first_layer_is_a_dense_mlp(smoke):
    """Layer 0's FFN is the dense gated MLP of ``d_ff`` (the ``dense``
    stack), the others' the MoE (the ``moe`` stack); changing the dense
    MLP moves the logits as the reference's layer 0 says."""
    model, params = smoke
    layers = list(lm._layers(model.cfg, params))
    assert [k for k, *_ in layers] == ["mla"] * 3
    assert "mlp" in layers[0][1] and "moe" not in layers[0][1]
    assert layers[0][1]["mlp"]["wi"].shape == (64, 2 * model.cfg.d_ff)
    assert all("moe" in blk and "mlp" not in blk for _, blk, *_ in layers[1:])
    seq = _tokens(24, 5)
    moved = dict(params, dense={"mlp": {
        "wi": params["dense"]["mlp"]["wi"] * 1.5,
        "wo": params["dense"]["mlp"]["wo"]}})
    with torch.no_grad():
        a, _ = model.forward(params, {"tokens": seq[None]})
        b, _ = model.forward(moved, {"tokens": seq[None]})
    want = REF.logits(_ref_cfg(model.cfg), moved, seq, torch.arange(24))
    assert float((a - b).abs().max()) > 1e-2
    assert float((b[0, :, :model.cfg.vocab] - want).abs().max()) < TOL


def _serve(model, params, reqs, n_slots):
    """Serves ``reqs`` through an engine over a kernel-level transfer
    engine on a private runtime; returns each request's logits rows (its
    prefill's, then its decodes') by rid."""
    rows: dict[int, list] = {}
    order: list[int] = []
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
    """Request 2 (a ragged chunked prefill of 21 tokens) lands in the slot
    request 0 left, its latent rows overwritten whole while the other slot
    decodes request 1; it serves what it serves alone in a fresh engine,
    and its rows match the reference's forward."""
    model, params = smoke

    def req(rid, n, seed, new):
        return Request(rid=rid, prompt=_tokens(n, seed).numpy().astype(
            np.int32), max_new_tokens=new)

    shared = _serve(model, params, [req(0, 30, 3, 6), req(1, 12, 4, 14),
                                    req(2, 21, 5, 8)], 2)
    alone = _serve(model, params, [req(2, 21, 5, 8)], 2)
    assert shared[2][0] == alone[2][0]
    assert float((shared[2][1] - alone[2][1]).abs().max()) < TOL
    toks, got = shared[2]
    seq = torch.cat([_tokens(21, 5), torch.tensor(toks[:-1])])
    want = REF.logits(_ref_cfg(model.cfg), params, seq,
                      torch.arange(20, 20 + len(toks)))
    assert float((got[:, :model.cfg.vocab] - want).abs().max()) < TOL


NEW_DEFAULTS = dict(kv_lora_rank=0, qk_nope_head_dim=0, qk_rope_head_dim=0,
                    v_head_dim=0, yarn_factor=0.0, yarn_original_max_pos=4096,
                    yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=1.0,
                    first_k_dense=0, moe_renormalize=True,
                    moe_ragged_tokens=1)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_the_moe_configs_are_unchanged_by_the_new_fields(arch):
    """granite-moe's and deepseek-moe-16b's smoke logits, prefill then
    decode, with the new fields at their defaults: equal to the JAX
    reference's as before (f32, 1e-5), and bitwise to the same config with
    those defaults written out."""
    import jax

    cfg = smoke_config(arch).replace(dtype="float32")
    jcfg = jregistry.smoke_config(arch).replace(dtype="float32")
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(5))
    params = lm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 20))
    want = np.asarray(jmodel.forward(jparams, {"tokens": tokens})[0])
    jl, jc = jmodel.prefill(jparams, {"tokens": tokens[:, :16]}, 24)
    jd, _ = jmodel.decode(jparams, tokens[:, 16:17], jc)
    out = []
    for c in (cfg, cfg.replace(**NEW_DEFAULTS)):
        m = build_model(c)
        with torch.no_grad():
            fw = m.forward(params, {"tokens": torch.from_numpy(tokens)})[0]
            pl, pc = m.prefill(params, {"tokens": torch.from_numpy(
                tokens[:, :16])}, 24)
            dl, _ = m.decode(params, torch.from_numpy(tokens[:, 16:17]), pc)
        out.append((fw, pl, dl))
    (fw, pl, dl), again = out
    np.testing.assert_allclose(fw.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(out[0], again))


def test_granite_4h_is_unchanged_by_the_new_fields():
    """granite-4.0-h-small's smoke logits: against its reference as before
    (f32, 1e-5), and bitwise with the new fields' defaults written out."""
    cfg = smoke_config("granite-4.0-h-small").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(6), device="cpu")
    seq = torch.randint(0, cfg.vocab, (30,),
                        generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got, _ = model.forward(params, {"tokens": seq[None]})
        again, _ = build_model(cfg.replace(**NEW_DEFAULTS)).forward(
            params, {"tokens": seq[None]})
    href = spec.load_module("reference", "hybrid_lm")
    hcfg = {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "layer_types": list(cfg.layer_types),
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "intermediate_size": cfg.d_expert,
        "num_experts_per_tok": cfg.top_k, "vocab_size": cfg.vocab,
        "mamba_expand": cfg.ssm_expand, "mamba_n_heads": cfg.n_ssm_heads,
        "mamba_d_head": cfg.ssm_head_dim, "mamba_n_groups": cfg.ssm_groups,
        "mamba_d_state": cfg.ssm_state, "mamba_d_conv": cfg.ssm_conv_width,
        "rms_norm_eps": cfg.norm_eps,
        "embedding_multiplier": cfg.embedding_multiplier,
        "residual_multiplier": cfg.residual_multiplier,
        "attention_multiplier": cfg.attention_multiplier,
        "logits_scaling": cfg.logits_scaling}
    want = href.logits(hcfg, params, seq, torch.arange(30))
    assert float((got[0, :, :cfg.vocab] - want).abs().max()) < 1e-5
    assert torch.equal(got, again)
