"""The cell ``dsv2lite.longdoc`` (DeepSeek-V2-Lite, the mla builder and
reference) at its smoke sizes on the CPU: a sound run is correct; a served
token altered where the program produces it, a latent row's roped key
zeroed in the program's cache and the fp8 control are not; the latent
kernel's counts against a hand count; the new readers on hand-made
records, and nothing without a trace."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from perfbench.lib import spec
from perfbench.lib.trace import Trace
from perfbench.tests import helpers

from repro_torch.utils import trace

CELL = "dsv2lite.longdoc"
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
    cb = spec.load_module("configs", "mla_lm")
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


def test_a_zeroed_roped_key_is_not_correct(monkeypatch):
    """Each prefill leaves the k^R of its prompt's last latent row zero in
    every layer of the cache it returns (the row's c is kept)."""
    def fault(model, cfg):
        def prefill(params, batch, s_max):
            logits, cache = model.prefill(params, batch, s_max)
            cache.kv[:, :, cache.length - 1, cfg["kv_lora_rank"]:] = 0
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


def test_the_longdoc_mix():
    chat = spec.load_module("drivers", "chat")
    tr = spec.cell(CELL)["traffic"]
    p = chat.lengths(tr["prompt"], tr["pool"])
    o = chat.lengths(tr["output"], tr["pool"])
    assert p.min() == 4096 and p.max() == 16384 and np.median(p) == 8192
    assert o.min() == 128 and o.max() == 2048 and np.median(o) == 768
    assert p.max() + o.max() <= tr["max_seq"]
    assert tr["n_slots"] == tr["clients"] == 32


def test_latent_counts_match_a_hand_count():
    """16 heads, c of 512, k^R of 64; 1,000 rows over 2 calls of 3 slots."""
    counts = spec.load_module("counts", "mla_lm")
    cfg = spec.cell(CELL)["config"]
    flops, nbytes = counts.latent_decode(cfg, 1000, 2, 3)
    # a row: scores 16 x 576 x 2, values 16 x 512 x 2
    assert flops == 1000 * (18432 + 16384)
    # a row 1,152 bytes; a call a slot's q~ 16 x 576 and out 16 x 512, bf16
    assert nbytes == 1000 * 1152 + 2 * 3 * (18432 + 16384)


def _steps(prefills: int) -> list:
    """Two steps of 100 ms; ``prefills`` latent prefills of 3 ms (a layer
    each) in the first."""
    def rec(name, t0, dur, seq, parent=None):
        return trace.Record(name, t0, t0 + dur, parent, 1, None, seq)

    out = []
    for i in range(2):
        t, s = i * 200 * MS, 100 * i
        out.append(rec("serve.step", t, 100 * MS, s))
        for j in range(prefills if i == 0 else 0):
            out.append(rec("mla.prefill", t + j * 5 * MS, 3 * MS, s + 1 + j,
                           s))
    return out


@pytest.fixture
def program(monkeypatch):
    def put(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


def test_the_latent_prefill_reader(program):
    read = spec.load_module("metrics", "mla_prefill_ms.serve").read
    program(_steps(4), {})
    assert read({}) == pytest.approx(6.0)  # 12 ms over 2 steps
    program(_steps(0), {})  # a window without a prefill: nothing
    assert read({}) is None
    program([], {})
    assert read({}) is None


def test_the_latent_roofline_reader(program):
    run = helpers.smoke_run(CELL)
    cfg, tr = spec.cell(CELL)["config"], run.traffic
    counts = spec.load_module("counts", "mla_lm")
    peaks = spec.load_module("counts", "peaks")
    mod = spec.load_module("metrics", "mla_decode_roofline.serve")
    rows, calls = 3 * 27 * 9000, 3 * 27
    least = peaks.least_s(*counts.latent_decode(cfg, rows, calls,
                                                tr["n_slots"]),
                          peaks.BF16_FLOPS)
    ops = {"void (anonymous namespace)::mla_decode_split_kernel(Params)":
           (3 * least, calls),
           "void (anonymous namespace)::mla_decode_merge_kernel(Params)":
           (least, calls),
           "decode_attention_split_kernel<64, 2>": (1.0, 7), "gemv": (1.0, 9)}
    tr_ = Trace(1.0, 0.5, ops, [])
    ctx = {"trace": tr_, "config": cfg, "traffic": tr}
    program(_steps(0), {"attn.decode_latent": calls,
                        "attn.latent_rows": rows})
    assert mod.read(ctx) == pytest.approx(25.0)
    # launches the program did not count, no rows, no trace: nothing
    program(_steps(0), {"attn.decode_latent": calls + 1,
                        "attn.latent_rows": rows})
    assert mod.read(ctx) is None
    program(_steps(0), {"attn.decode_latent": calls})
    assert mod.read(ctx) is None
    program(_steps(0), {})
    assert mod.read(dict(ctx, trace=Trace(1.0, 0.5, {}, []))) is None
    assert mod.read(dict(ctx, trace=None)) is None


def test_the_gqa_reader_does_not_read_the_latent_kernel(program):
    """``attn_decode_us.serve`` matches ``decode_attention_split`` by
    substring: the latent kernel's launches are not among them."""
    mod = spec.load_module("metrics", "attn_decode_us.serve")
    ops = {"void (anonymous namespace)::mla_decode_split_kernel(Params)":
           (1.0, 27), "void (anonymous namespace)::mla_decode_merge_kernel("
           "Params)": (1.0, 27)}
    program(_steps(0), {"attn.decode_latent": 27})
    assert mod.read({"trace": Trace(1.0, 0.5, ops, [])}) is None
