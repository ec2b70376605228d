"""The cell ``kimilinear.agent`` (Kimi-Linear-48B-A3B, the kda_lm builder
and reference) at its smoke sizes on the CPU: a sound run is correct; a
served token altered where the program produces it, a KDA state zeroed in
the program's cache after a prefill and the fp8 control are not; the
reference against itself through the chunked prefill's split; the KDA
kernels' counts against a hand count; the new readers on hand-made
records, and nothing without a trace."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from perfbench.lib import spec
from perfbench.lib.trace import Trace
from perfbench.tests import helpers

from repro_torch.utils import trace

CELL = "kimilinear.agent"
MS = 1_000_000
# the smoke run's window: long enough that requests finish on a CPU shared
# with the rest of the test run
SECONDS = 3.0


def test_a_sound_run_is_correct():
    out = helpers.execute(helpers.smoke_run(CELL, seconds=SECONDS))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}


def _faulty(monkeypatch, fault):
    """The builder's program with ``fault(model, cfg)``'s prefill and
    decode in the model's place."""
    cb = spec.load_module("configs", "kda_lm")
    real_program = cb.program

    def program(cfg):
        model = real_program(cfg)
        return dataclasses.replace(model, **fault(model, cfg))

    monkeypatch.setattr(cb, "program", program)
    return helpers.execute(helpers.smoke_run(CELL, seconds=SECONDS))


def test_an_altered_token_is_not_correct(monkeypatch):
    """Every third decode step, each slot's token is moved off the
    program's argmax where the step produces it."""
    def fault(model, cfg):
        calls = {"n": 0}

        def decode(params, token, cache):
            logits, cache = model.decode(params, token, cache)
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                v = cfg["vocab_size"]
                alt = (logits[:, -1, :v].argmax(-1) + 1) % v
                rows = logits[:, -1]
                rows[range(rows.shape[0]), alt] = rows.max(-1).values + 1.0
            return logits, cache

        return {"decode": decode}

    out = _faulty(monkeypatch, fault)
    assert not out["correct"], out["checks"]


def test_a_zeroed_kda_state_is_not_correct(monkeypatch):
    """Each prefill leaves its KDA layers' states zero in the cache it
    returns (the latent rows and conv tails are kept): the decode steps
    after it forget the prompt in those layers."""
    def fault(model, cfg):
        def prefill(params, batch, s_max):
            logits, cache = model.prefill(params, batch, s_max)
            cache.kda.zero_()
            return logits, cache

        return {"prefill": prefill}

    out = _faulty(monkeypatch, fault)
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    run = helpers.smoke_run(CELL, seconds=SECONDS)
    got = spec.load_module("drivers", "chat").control(run)
    failed = [k for k in run.limits
              if got[f"{k}[fp8]"] > run.limits[k]["limit"]]
    assert failed, got
    assert all(got[k] <= run.limits[k]["limit"] for k in run.limits), got


def test_the_bf16_state_control_rounds_the_state_alone(monkeypatch):
    """With ``CONTROL`` "bf16_state" the reference's ``fp8=True`` rounds
    KDA's state, decay and beta to bfloat16 and nothing else: its KDA
    output moves off the float32 recurrence's by bf16's rounding, and a
    layer of latent attention alone (no KDA) is the float32 one bitwise."""
    ref = spec.load_module("reference", "kda_lm")
    g = torch.Generator().manual_seed(5)
    s, h, d = 40, 2, 16
    q = torch.nn.functional.normalize(torch.randn((s, h, d), generator=g),
                                      dim=-1) * d ** -0.5
    k = torch.nn.functional.normalize(torch.randn((s, h, d), generator=g),
                                      dim=-1)
    v = torch.randn((s, h, d), generator=g)
    dec = -torch.rand((s, h, d), generator=g) * 0.5
    beta = torch.rand((s, h), generator=g)
    exact = ref.recurrence(q, k, v, dec, beta)
    low = ref.recurrence(q, k, v, dec, beta, bf16_state=True)
    err = float((low - exact).pow(2).mean().sqrt()
                / exact.pow(2).mean().sqrt())
    assert 1e-4 < err < 3e-2, err
    cfg = spec.cell(CELL)["config"]
    smoke = {**cfg, **cfg["smoke"]}
    cb = spec.load_module("configs", "kda_lm")
    params = cb.make_params(smoke, 3, "cpu")
    toks = torch.arange(12) % smoke["vocab_size"]
    rows = torch.arange(12)
    want = ref.logits(smoke, params, toks, rows)
    monkeypatch.setattr(ref, "CONTROL", "bf16_state")
    got = ref.logits(smoke, params, toks, rows, fp8=True)
    assert not torch.equal(got, want)
    assert float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt()) < 5e-2
    mla_only = {**smoke, "num_hidden_layers": 1, "first_k_dense_replace": 1,
                "linear_attn_config": {**smoke["linear_attn_config"],
                                       "full_attn_layers": [1],
                                       "kda_layers": []}}
    one = cb.make_params(mla_only, 3, "cpu")
    monkeypatch.setattr(ref, "CONTROL", "fp8")
    want = ref.logits(mla_only, one, toks, rows)
    monkeypatch.setattr(ref, "CONTROL", "bf16_state")
    assert torch.equal(ref.logits(mla_only, one, toks, rows, fp8=True), want)


def test_the_agent_mix():
    chat = spec.load_module("drivers", "chat")
    tr = spec.cell(CELL)["traffic"]
    p = chat.lengths(tr["prompt"], tr["pool"])
    o = chat.lengths(tr["output"], tr["pool"])
    assert p.min() == 4096 and p.max() == 32768 and np.median(p) == 12288
    assert o.min() == 1024 and o.max() == 8192 and np.median(o) == 3072
    assert p.max() + o.max() <= tr["max_seq"] == 40960
    assert tr["n_slots"] == tr["clients"] == 64


def test_the_configuration_is_the_catalogs_but_the_experts_held():
    """Every published number as the catalog row gives it, the layer
    pattern 3 : 1 with the latent layers at 0-based 3, 7, ..., 23 and 26,
    and the one cut (64 experts held of 256) listed in ``reduced``."""
    cfg = spec.cell(CELL)["config"]
    cb = spec.load_module("configs", "kda_lm")
    kinds = cb.layer_types(cfg)
    assert [i for i, k in enumerate(kinds) if k == "mla"] == [
        3, 7, 11, 15, 19, 23, 26]
    assert len(kinds) == 27 and kinds.count("kda") == 20
    assert cfg["num_experts"] == 64 and cfg["num_experts_published"] == 256
    assert cfg["reduced"] == ["num_experts"]
    s = cb.sizes(cfg)
    assert (s["d"], s["kh"], s["kd"], s["kr"], s["e_all"], s["k"]) == (
        2304, 32, 128, 128, 256, 8)
    mc = cb.program(cfg).cfg
    assert (mc.n_experts, mc.n_experts_held, mc.expert_offset,
            mc.moe_score, mc.moe_routed_scale, mc.mla_nope) == (
        256, 64, 0, "sigmoid", 2.446, True)


def test_the_reference_recurrence_is_the_chunked_form():
    """The reference's token-by-token delta rule against the port's plain
    chunkwise form (``kernels/kda/ref.py``) on the same inputs: f32
    agreement to 1e-5 of the output's RMS, over a length that spans three
    chunks and ends inside the fourth."""
    from repro_torch.kernels.kda.ref import kda_chunk_ref

    ref = spec.load_module("reference", "kda_lm")
    g = torch.Generator().manual_seed(3)
    s, h, d = 150, 3, 16
    q = torch.nn.functional.normalize(torch.randn((s, h, d), generator=g),
                                      dim=-1)
    k = torch.nn.functional.normalize(torch.randn((s, h, d), generator=g),
                                      dim=-1)
    v = torch.randn((s, h, d), generator=g)
    dec = -torch.rand((s, h, d), generator=g) * 2
    beta = torch.rand((s, h), generator=g)
    want = ref.recurrence(q, k, v, dec, beta)
    st = torch.zeros((1, h, d, d))
    got = kda_chunk_ref(q[None], k[None], v[None], dec[None], beta[None],
                        st)[0]
    tol = 1e-5 * want.pow(2).mean().sqrt()
    assert float((got - want).abs().max()) <= tol


def test_kda_counts_match_a_hand_count():
    """32 heads of 128; 4,096 tokens in 2 calls, and 2 decode calls over 64
    slots."""
    counts = spec.load_module("counts", "kda_lm")
    cfg = spec.cell(CELL)["config"]
    flops, nbytes = counts.chunk_prefill(cfg, 4096, 2)
    pairs, d = 64 * 65 // 2, 128
    chunk = 5 * pairs * d + 64 * 63 * 2 * d + 6 * 64 * d * d \
        + 2 * pairs * d + d * d
    assert flops == pytest.approx(64 * 32 * chunk)
    # a token: q, k, v, o bf16 (4 x 128 x 2), g f32 (128 x 4), beta (4), a
    # head; the state in and out a call
    assert nbytes == 4096 * 32 * (1024 + 512 + 4) + 2 * 2 * 32 * d * d * 4
    flops, nbytes = counts.decode_step(cfg, 2, 64)
    assert flops == 2 * 64 * 32 * 7 * d * d
    assert nbytes == 2 * 64 * 32 * (2 * d * d * 4 + 1024 + 512 + 4)


def _steps(prefills: int) -> list:
    """Two steps of 100 ms; ``prefills`` KDA prefills of 3 ms (a layer
    each) in the first."""
    def rec(name, t0, dur, seq, parent=None):
        return trace.Record(name, t0, t0 + dur, parent, 1, None, seq)

    out = []
    for i in range(2):
        t, s = i * 200 * MS, 100 * i
        out.append(rec("serve.step", t, 100 * MS, s))
        for j in range(prefills if i == 0 else 0):
            out.append(rec("kda.prefill", t + j * 5 * MS, 3 * MS, s + 1 + j,
                           s))
    return out


@pytest.fixture
def program(monkeypatch):
    def put(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


def test_the_kda_prefill_reader(program):
    read = spec.load_module("metrics", "kda_prefill_ms.serve").read
    program(_steps(4), {})
    assert read({}) == pytest.approx(6.0)  # 12 ms over 2 steps
    program(_steps(0), {"kda.step": 40})  # decode steps alone: 0
    assert read({}) == 0.0
    program(_steps(0), {})  # a program without KDA: nothing
    assert read({}) is None
    program([], {})
    assert read({}) is None


def test_the_kda_scan_roofline_reader(program):
    run = helpers.smoke_run(CELL)
    cfg, tr = spec.cell(CELL)["config"], run.traffic
    counts = spec.load_module("counts", "kda_lm")
    peaks = spec.load_module("counts", "peaks")
    mod = spec.load_module("metrics", "kda_scan_roofline.serve")
    calls, tokens = 4, 4 * 3000
    least = peaks.least_s(*counts.chunk_prefill(cfg, tokens, calls),
                          peaks.F32_FLOPS)
    ops = {"void (anonymous namespace)::kda_intra_kernel(ChunkParams)":
           (3 * least, calls),
           "void (anonymous namespace)::kda_state_kernel(ChunkParams)":
           (least, calls),
           "void (anonymous namespace)::kda_step_kernel(StepParams)":
           (1.0, 7)}
    ctx = {"trace": Trace(1.0, 0.5, ops, []), "config": cfg, "traffic": tr}
    program(_steps(calls), {"kda.scan_tokens": tokens})
    assert mod.read(ctx) == pytest.approx(25.0)
    # launches the program did not record, no tokens, no trace: nothing
    program(_steps(calls + 1), {"kda.scan_tokens": tokens})
    assert mod.read(ctx) is None
    program(_steps(calls), {})
    assert mod.read(ctx) is None
    program(_steps(0), {})
    assert mod.read(dict(ctx, trace=Trace(1.0, 0.5, {}, []))) is None
    assert mod.read(dict(ctx, trace=None)) is None


def test_the_kda_step_roofline_reader(program):
    run = helpers.smoke_run(CELL)
    cfg, tr = spec.cell(CELL)["config"], run.traffic
    counts = spec.load_module("counts", "kda_lm")
    peaks = spec.load_module("counts", "peaks")
    mod = spec.load_module("metrics", "kda_step_roofline.serve")
    calls = 20 * 128
    least = peaks.least_s(*counts.decode_step(cfg, calls, tr["n_slots"]),
                          peaks.F32_FLOPS)
    ops = {"void (anonymous namespace)::kda_step_kernel(StepParams)":
           (2 * least, calls),
           "void (anonymous namespace)::kda_intra_kernel(ChunkParams)":
           (1.0, 20)}
    ctx = {"trace": Trace(1.0, 0.5, ops, []), "config": cfg, "traffic": tr}
    program(_steps(0), {"kda.step": calls})
    assert mod.read(ctx) == pytest.approx(50.0)
    program(_steps(0), {"kda.step": calls + 20})
    assert mod.read(ctx) is None
    program(_steps(0), {})
    assert mod.read(ctx) is None
    assert mod.read(dict(ctx, trace=None)) is None


def test_the_config_file_repeats_the_catalog_row():
    """The counts the shared LM code reads are present: the chat driver's
    model FLOPs run over the configuration."""
    cfg = spec.cell(CELL)["config"]
    chat = spec.load_module("drivers", "chat")
    assert chat._flops(cfg, 12288, 0, 2) > 0
    assert json.loads(json.dumps(cfg)) == cfg
