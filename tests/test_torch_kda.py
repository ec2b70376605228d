"""The linear_mla family (Kimi-Linear-48B-A3B) on the CPU, at the smoke
size (the dense layer and a whole 3 : 1 period, small widths): KDA's
chunked plain version and its decode step against the token-by-token
recurrence; prefill (through ``prefill_chunk`` boundaries) then decode
through the ``KDACache`` against the plain reference's full forward
(``perfbench/reference/kda_lm.py``), on logits; the sigmoid router; the
four cards' expert shares against the uncut layer; the splice of the new
cache; the counters; and the existing MoE configurations unchanged by the
new fields.

Tolerances: f32 against f32 computed in another order (the chunkwise form
against the recurrence, a chunked prefill against one pass) agree to
~1e-6 of the values' scale; ``TOL`` leaves a factor of ten. There is no
JAX counterpart of the family."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from perfbench.lib import spec
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.kernels.kda.ops import kda_chunk, kda_step
from repro_torch.kernels.kda.ref import (
    kda_chunk_ref, kda_recurrent_ref, kda_step_ref)
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers import moe
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request
from repro_torch.utils import trace

torch.set_num_threads(1)

ARCH = "kimi-linear-48b-a3b-instruct"
REF = spec.load_module("reference", "kda_lm")
TOL = 2e-5  # f32 against f32 in another order (module docstring)


def _inputs(b, s, h=3, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn((b, s, h, d), generator=g),
                                      dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn((b, s, h, d), generator=g),
                                      dim=-1)
    v = torch.randn((b, s, h, d), generator=g)
    dec = -torch.rand((b, s, h, d), generator=g) ** 2 * 3
    beta = torch.rand((b, s, h), generator=g)
    st = torch.randn((b, h, d, d), generator=g)
    return q, k, v, dec, beta, st


def _err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


# one token, a chunk's edges, several chunks ending inside one
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
def test_chunked_kda_matches_the_recurrence(s):
    """From a nonzero state: the output and the final state."""
    q, k, v, dec, beta, st = _inputs(2, s, seed=s)
    want_st, got_st = st.clone(), st.clone()
    want = kda_recurrent_ref(q, k, v, dec, beta, want_st)
    got = kda_chunk_ref(q, k, v, dec, beta, got_st)
    assert _err(got, want) < TOL and _err(got_st, want_st) < TOL


def test_chunks_of_a_sequence_carry_the_state():
    """A sequence in two calls (split inside a chunk) is the sequence in
    one: the state the first leaves is the one the second starts from."""
    q, k, v, dec, beta, st = _inputs(1, 150, seed=9)
    whole_st, split_st = st.clone(), st.clone()
    whole = kda_chunk(q, k, v, dec, beta, whole_st)
    first = kda_chunk(q[:, :70], k[:, :70], v[:, :70], dec[:, :70],
                      beta[:, :70], split_st)
    rest = kda_chunk(q[:, 70:], k[:, 70:], v[:, 70:], dec[:, 70:],
                     beta[:, 70:], split_st)
    assert _err(torch.cat([first, rest], 1), whole) < TOL
    assert _err(split_st, whole_st) < TOL


def test_the_decode_step_matches_the_recurrence():
    """Five steps of every slot, in place on a view of a stacked state."""
    q, k, v, dec, beta, st = _inputs(4, 5, seed=3)
    want_st = st.clone()
    want = kda_recurrent_ref(q, k, v, dec, beta, want_st)
    stack = torch.stack([torch.zeros_like(st), st.clone()])
    for t in range(5):
        got = kda_step(q[:, t], k[:, t], v[:, t], dec[:, t], beta[:, t],
                       stack[1])
        assert _err(got, want[:, t]) < TOL
    assert _err(stack[1], want_st) < TOL
    assert not stack[0].any()


def test_kda_counters_tick():
    q, k, v, dec, beta, st = _inputs(2, 10)
    with trace.tally() as counts:
        kda_chunk(q, k, v, dec, beta, st)
        kda_step(q[:, 0], k[:, 0], v[:, 0], dec[:, 0], beta[:, 0], st)
    assert counts == {"kda.scan_tokens": 20, "kda.step": 1}
    assert torch.equal(kda_step_ref(q[:, 0], k[:, 0], v[:, 0], dec[:, 0],
                                    beta[:, 0], st.clone()),
                       kda_step(q[:, 0], k[:, 0], v[:, 0], dec[:, 0],
                                beta[:, 0], st.clone()))


def test_the_registry_gives_the_published_widths():
    cfg = get_config(ARCH)
    assert cfg.family == "linear_mla" and cfg.n_layers == 27
    assert cfg.latent_layers == (3, 7, 11, 15, 19, 23, 26)
    assert len(cfg.kda_layers) == 20
    assert (cfg.d_model, cfg.vocab, cfg.kda_heads, cfg.kda_head_dim,
            cfg.kda_conv_width, cfg.n_heads, cfg.kv_lora_rank,
            cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (
        2304, 163840, 32, 128, 4, 32, 512, 128, 64, 128)
    assert (cfg.d_ff, cfg.first_k_dense, cfg.n_experts, cfg.top_k,
            cfg.n_shared_experts, cfg.d_expert, cfg.norm_eps) == (
        9216, 1, 256, 8, 1, 1024, 1e-5)
    assert (cfg.moe_score, cfg.moe_routed_scale, cfg.experts_held,
            cfg.mla_nope, cfg.prefill_chunk) == ("sigmoid", 2.446, 64, True,
                                                 4096)


def _ref_cfg(cfg) -> dict:
    """The reference's configuration (kimi_linear's keys) of a port
    ``ModelConfig``."""
    return {
        "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_head_dim,
        "qk_rope_head_dim": cfg.qk_rope_head_dim,
        "v_head_dim": cfg.v_head_dim,
        "linear_attn_config": {
            "num_heads": cfg.kda_heads, "head_dim": cfg.kda_head_dim,
            "short_conv_kernel_size": cfg.kda_conv_width,
            "full_attn_layers": [i + 1 for i in cfg.latent_layers]},
        "first_k_dense_replace": cfg.first_k_dense,
        "num_experts_per_token": cfg.top_k,
        "routed_scaling_factor": cfg.moe_routed_scale,
        "expert_offset": cfg.expert_offset, "rms_norm_eps": cfg.norm_eps,
        "vocab_size": cfg.vocab}


@pytest.fixture(scope="module")
def smoke():
    """The smoke model in f32 and its params, with every norm scale and
    the output gate's bias moved off their initial values."""
    cfg = smoke_config(ARCH).replace(dtype="float32")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(2**31 + 13)
    params = model.init(g, device="cpu")
    for tree, key in ((params["blocks"]["ln1"], "scale"),
                      (params["blocks"]["ln2"], "scale"),
                      (params["mla"]["kv_norm"], "scale"),
                      (params["final_norm"], "scale"),
                      (params["kda"], "o_norm"), (params["kda"], "g_bias")):
        tree[key] = tree[key] + 0.1 * torch.randn(tree[key].shape,
                                                  generator=g)
    return model, params


def _tokens(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, smoke_config(ARCH).vocab, (n,), generator=g)


def test_prefill_then_decode_matches_the_reference(smoke):
    """A 37-token prompt (prefill chunks of 16, 16 and 5, the KDA state
    and conv tails carried between them) then 6 decode steps through the
    ``KDACache``: every logits row within ``TOL`` of the reference's full
    forward over the same tokens."""
    model, params = smoke
    seq = _tokens(43, 1)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": seq[None, :37]}, 64)
        rows = [logits[0, -1]]
        for t in range(37, 43):
            logits, cache = model.decode(params, seq[None, t:t + 1], cache)
            rows.append(logits[0, -1])
    assert isinstance(cache, lm.KDACache) and cache.length == 43
    got = torch.stack(rows)[:, :model.cfg.vocab]
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(36, 43))
    assert _err(got, want) < TOL


def test_the_forward_matches_the_reference(smoke):
    model, params = smoke
    seq = _tokens(30, 2)
    with torch.no_grad():
        got = model.forward(params, {"tokens": seq[None]})[0][0]
    want = REF.logits(_ref_cfg(model.cfg), params, seq, torch.arange(30))
    assert _err(got[:, :model.cfg.vocab], want) < TOL


def test_the_sigmoid_router_chooses_by_bias_but_weights_by_score():
    """A bias that lifts expert 5 over every other puts it among each
    token's top k, with the weight of its own score (renormalised over the
    k, times the routed scale); without the bias the k are the top scores."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((6, 8), generator=g)
    router = torch.randn((8, 10), generator=g)
    bias = torch.zeros(10)
    bias[5] = 100.0
    probs, w, idx = moe._gates(x, router, 3, score="sigmoid", bias=bias,
                               scale=2.5)
    scores = torch.sigmoid(x @ router)
    assert torch.equal(probs, scores)
    assert bool((idx == 5).any(-1).all())
    picked = scores.gather(-1, idx)
    assert torch.allclose(w, picked / picked.sum(-1, keepdim=True) * 2.5)
    _, _, plain = moe._gates(x, router, 3, score="sigmoid", scale=2.5)
    assert torch.equal(plain, scores.topk(3, -1).indices)


def _share(p: dict, first: int, n: int) -> dict:
    out = dict(p)
    out["we_up"], out["we_down"] = (p[k][first:first + n]
                                    for k in ("we_up", "we_down"))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_shares_add_up_to_the_uncut_layer(dtype):
    """The layer as four cards' shares (4 of 16 experts each, offsets 0,
    4, 8, 12), each routing over all 16, plus the shared expert counted
    once, equals the uncut layer and the reference's: f32 through the
    padded buffer to ``TOL``; bf16 (a prefill, the grouped route) to 2% of
    the uncut output's scale, bf16's rounding of four sums."""
    g = torch.Generator().manual_seed(7)
    dt = getattr(torch, dtype)
    p = moe.moe_params(g, 32, 16, 8, 1, dt, "cpu", router_bias=True)
    x = torch.randn((1, 24, 32), generator=g).to(dt)
    tol = TOL if dtype == "float32" else 0.02
    kw = dict(top_k=4, renormalize=True, score="sigmoid", routed_scale=2.446,
              ragged_tokens=1)
    with torch.no_grad():
        whole, _ = moe.moe_apply(p, x, capacity_factor=16 / 4, **kw)
        shared = moe._shared_experts(p, x[0], torch.zeros_like(x[0]))
        got = [moe.moe_apply(_share(p, i * 4, 4), x, capacity_factor=1.0,
                             expert_offset=i * 4, **kw)[0][0]
               for i in range(4)]
    parts = sum(one.float() - shared.float() for one in got)
    assert _err(parts + shared.float(), whole[0].float()) < tol
    cfg = {"num_experts_per_token": 4, "routed_scaling_factor": 2.446,
           "expert_offset": 0}
    pf = {k: v.float() for k, v in p.items()}
    want = REF._moe(cfg, pf, x[0].float(), False)
    assert _err(whole[0].float(), want) < tol
    for i in range(4):
        one = REF._moe(dict(cfg, expert_offset=i * 4), _share(pf, i * 4, 4),
                       x[0].float(), False)
        assert _err(got[i].float(), one) < tol


def test_the_grouped_share_is_the_padded_share_in_bf16():
    """A prefill's share through the grouped route (seats held elsewhere
    sorted past the last group) against the padded buffer, bf16: within
    bf16's rounding of each row. The padded buffer counts its E * C rows,
    the grouped route the held seats alone; both count every seat the
    router fills."""
    g = torch.Generator().manual_seed(8)
    p = moe.moe_params(g, 64, 8, 16, 1, torch.bfloat16, "cpu", n_routed=32,
                       router_bias=True)
    x = torch.randn((1, 40, 64), generator=g).to(torch.bfloat16)
    kw = dict(top_k=4, capacity_factor=2.0, renormalize=True,
              score="sigmoid", routed_scale=2.446, expert_offset=8)
    with torch.no_grad(), trace.tally() as counts:
        want, _ = moe.moe_apply(p, x, **kw)
        got, _ = moe.moe_apply(p, x, ragged_tokens=1, **kw)
    idx = moe._gates(x[0], p["router"], 4, score="sigmoid",
                     bias=p["router_bias"])[2]
    held = int(((idx >= 8) & (idx < 16)).sum())
    assert 0 < held < 4 * 40
    assert counts == {"moe.rows": 8 * 40 + held, "moe.seats": 2 * 4 * 40}
    err = (got.float() - want.float()).pow(2).mean(-1).sqrt() \
        / want.float().pow(2).mean(-1).sqrt()
    assert bool((err < 0.02).all()), err


@contextlib.contextmanager
def _engine(model, params, **kw):
    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(), device="cpu",
                              runtime=rt)
    eng = ContinuousBatchingEngine(model, params, transfer=transfer, **kw)
    try:
        yield eng
    finally:
        eng.close()
        transfer.close()
        rt.close()


def _serve(model, params, reqs, n_slots):
    rows: dict = {}
    real = model.decode

    def decode(ps, token, cache):
        logits, new = real(ps, token, cache)
        for slot, q in enumerate(eng.slots):
            if q is not None:
                rows.setdefault(q.rid, []).append(logits[slot, -1])
        return logits, new

    def prefill(ps, batch, s_max):
        logits, cache = model.prefill(ps, batch, s_max)
        prefilled.append(logits[0, -1])
        return logits, cache

    import dataclasses
    prefilled: list = []
    with _engine(dataclasses.replace(model, decode=decode, prefill=prefill),
                 params, n_slots=n_slots, max_seq=64) as eng:
        for r in reqs:
            assert eng.submit(r).admitted
        done = eng.run_to_completion()
    firsts = dict(zip([r.rid for r in reqs], prefilled))
    return {q.rid: (q.tokens, torch.stack([firsts[q.rid]] + rows.get(
        q.rid, [])[:len(q.tokens) - 1])) for q in done}


def test_a_spliced_slot_keeps_nothing_of_its_last_request(smoke):
    """Request 2 (a chunked prefill of 21 tokens) lands in the slot request
    0 left, its latent rows, KDA states and conv tails overwritten whole
    while the other slot decodes request 1; it serves what it serves alone
    in a fresh engine, and its rows match the reference's forward."""
    model, params = smoke

    def req(rid, n, seed, new):
        return Request(rid=rid, prompt=_tokens(n, seed).numpy().astype(
            np.int32), max_new_tokens=new)

    shared = _serve(model, params, [req(0, 30, 3, 6), req(1, 12, 4, 14),
                                    req(2, 21, 5, 8)], 2)
    alone = _serve(model, params, [req(2, 21, 5, 8)], 2)
    assert shared[2][0] == alone[2][0]
    assert _err(shared[2][1], alone[2][1]) < TOL
    toks, got = shared[2]
    seq = torch.cat([_tokens(21, 5), torch.tensor(toks[:-1])])
    want = REF.logits(_ref_cfg(model.cfg), params, seq,
                      torch.arange(20, 20 + len(toks)))
    assert _err(got[:, :model.cfg.vocab], want) < TOL


def test_the_engine_counts_the_latent_layers_rows_alone(smoke):
    """``attn.latent_rows`` a decode step: the active slots' live rows
    times the latent layers (1 of the smoke config's 5)."""
    model, params = smoke
    reqs = [Request(rid=i, prompt=_tokens(10 + i, i).numpy().astype(
        np.int32), max_new_tokens=4) for i in range(2)]
    with _engine(model, params, n_slots=2, max_seq=64) as eng:
        for r in reqs:
            assert eng.submit(r).admitted
        eng.step()
        trace.enabled()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.step()
            counts = trace.counters()
    assert len(model.cfg.latent_layers) == 1
    assert counts["attn.latent_rows"] == (11 + 1) + (12 + 1)
    assert counts["kda.step"] == len(model.cfg.kda_layers)


NEW_DEFAULTS = dict(kda_heads=0, kda_head_dim=128, kda_conv_width=4,
                    kda_gate_rank=128, mla_nope=False, moe_score="softmax",
                    moe_routed_scale=1.0, experts_held=0, expert_offset=0)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-4.0-h-small", "deepseek-v2-lite"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_moe_configs_are_unchanged_by_the_new_fields(arch, dtype):
    """The smoke logits of the configurations the benchmark runs, forward,
    prefill (chunked past ``prefill_chunk``) and decode: bitwise those of
    the same config with the new fields' defaults written out, and their
    MoE layers give the same router weights as a softmax top-k."""
    cfg = smoke_config(arch).replace(dtype=dtype)
    params = build_model(cfg).init(torch.Generator().manual_seed(5), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 40)))
    out = []
    for c in (cfg, cfg.replace(**NEW_DEFAULTS)):
        m = build_model(c)
        with torch.no_grad():
            fw = m.forward(params, {"tokens": tokens})[0]
            pl, pc = m.prefill(params, {"tokens": tokens[:, :36]}, 48)
            dl, _ = m.decode(params, tokens[:, 36:37], pc)
        out.append((fw, pl, dl))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    x = torch.randn((5, cfg.d_model), generator=torch.Generator().manual_seed(
        1))
    router = torch.randn((cfg.d_model, cfg.n_experts),
                         generator=torch.Generator().manual_seed(2))
    probs, w, idx = moe._gates(x, router, cfg.top_k, cfg.moe_renormalize)
    want_w, want_idx = torch.softmax(x @ router, -1).topk(cfg.top_k, -1)
    if cfg.moe_renormalize:
        want_w = want_w / want_w.sum(-1, keepdim=True).clamp_min(1e-9)
    assert torch.equal(idx, want_idx) and torch.equal(w, want_w)
