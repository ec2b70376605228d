"""The cell ``granite4h.rag`` (granite-4.0-h-small, the hybrid builder and
reference) at its smoke sizes on the CPU: a sound run is correct, a served
token altered where the program produces it and the fp8 control are not;
the SSD counts against a hand count; the new readers on hand-made
records."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from perfbench.lib import spec
from perfbench.lib.trace import Trace
from perfbench.tests import helpers

from repro_torch.utils import trace

CELL = "granite4h.rag"
MS = 1_000_000


def test_a_sound_run_is_correct():
    out = helpers.execute(helpers.smoke_run(CELL))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}


def test_an_altered_token_is_not_correct(monkeypatch):
    """Every third decode step, each slot's token is moved off the
    program's argmax where the step produces it."""
    cb = spec.load_module("configs", "hybrid_lm")
    real_program = cb.program

    def program(cfg):
        model = real_program(cfg)
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

        return dataclasses.replace(model, decode=decode)

    monkeypatch.setattr(cb, "program", program)
    out = helpers.execute(helpers.smoke_run(CELL))
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    run = helpers.smoke_run(CELL, seconds=0.5)
    got = spec.load_module("drivers", "chat").control(run)
    failed = [k for k in run.limits
              if got[f"{k}[fp8]"] > run.limits[k]["limit"]]
    assert failed, got
    assert all(got[k] <= run.limits[k]["limit"] for k in run.limits), got


def test_the_rag_mix():
    chat = spec.load_module("drivers", "chat")
    tr = spec.cell(CELL)["traffic"]
    p = chat.lengths(tr["prompt"], tr["pool"])
    o = chat.lengths(tr["output"], tr["pool"])
    assert p.min() == 256 and p.max() == 4096 and np.median(p) == 1536
    assert o.min() == 16 and o.max() == 512 and np.median(o) == 128
    assert p.max() + o.max() <= tr["max_seq"]


def test_ssd_counts_match_a_hand_count():
    """Q 4, H 2, P 3, G 1, N 5, bf16; 8 padded tokens (2 chunks) in one
    scan."""
    cb = spec.load_module("counts", "hybrid_lm")
    cfg = {"mamba_chunk_size": 4, "mamba_n_heads": 2, "mamba_d_head": 3,
           "mamba_n_groups": 1, "mamba_d_state": 5, "dtype": "bfloat16"}
    # a chunk: C.B 2*10*5 = 100; diagonal 2 heads x 2*10*3 = 120; states
    # 2 heads x 2*4*3*5 = 240
    assert cb.intra_chunk(cfg, 8)[0] == 2 * (100 + 120 + 240)
    # a token: x 2*3*2 B, B and C 2*5*2 B, dt 2*4 B, y 2*3*4 B; a chunk:
    # states 2*3*5*4 B, decays 2*4 B
    assert cb.intra_chunk(cfg, 8)[1] == 8 * (12 + 20 + 8 + 24) + 2 * (120 + 8)
    # a chunk's states and decays in, its entering state out; the initial
    # state in and the final one out once a scan
    assert cb.state_pass(cfg, 8, 1) == (2 * 2 * 30, 2 * (240 + 8) + 240)


def _steps(scans: int) -> list:
    """Two steps of 100 ms: ``scans`` scans of 3 ms in the first, two
    state steps of 1 ms in each."""
    def rec(name, t0, dur, seq, parent=None):
        return trace.Record(name, t0, t0 + dur, parent, 1, None, seq)

    out = []
    for i in range(2):
        t, s = i * 200 * MS, 100 * i
        out.append(rec("serve.step", t, 100 * MS, s))
        for j in range(scans if i == 0 else 0):
            out.append(rec("ssm.scan", t + j * 5 * MS, 3 * MS, s + 1 + j, s))
        for j in range(2):
            out.append(rec("ssm.step", t + 50 * MS + j * 2 * MS, MS,
                           s + 50 + j, s))
    return out


@pytest.fixture
def program(monkeypatch):
    def put(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


def test_the_ssm_span_readers(program):
    program(_steps(2), {})
    read = {m: spec.load_module("metrics", m).read
            for m in ("ssm_scan_ms.serve", "ssm_step_ms.serve")}
    assert read["ssm_scan_ms.serve"]({}) == pytest.approx(3.0)
    assert read["ssm_step_ms.serve"]({}) == pytest.approx(2.0)
    program(_steps(0), {})  # steps with no prefill scan nothing
    assert read["ssm_scan_ms.serve"]({}) == 0.0
    program([], {})
    assert all(f({}) is None for f in read.values())


def test_the_ssd_roofline_reader(program):
    cfg = spec.cell(CELL)["config"]
    counts = spec.load_module("counts", "hybrid_lm")
    peaks = spec.load_module("counts", "peaks")
    mod = spec.load_module("metrics", "ssd_roofline.serve")
    tokens = 2 * 4096  # two scans of 16 chunks
    least = (peaks.least_s(*counts.intra_chunk(cfg, tokens),
                           peaks.BF16_FLOPS)
             + peaks.least_s(*counts.state_pass(cfg, tokens, 2),
                             peaks.BF16_FLOPS))
    ops = {"void ssd_chunk_tc_kernel(Params)": (4 * least, 2),
           "ssd_state_pass_kernel": (least, 2), "gemv": (1.0, 9)}
    tr = Trace(1.0, 0.5, ops, [])
    program(_steps(2), {"ssm.scan_tokens": tokens})
    assert mod.read({"trace": tr, "config": cfg}) == pytest.approx(20.0)
    # a launch the program did not record, no scan, no trace: nothing
    program(_steps(3), {"ssm.scan_tokens": tokens})
    assert mod.read({"trace": tr, "config": cfg}) is None
    program(_steps(0), {})
    assert mod.read({"trace": Trace(1.0, 0.5, {}, []), "config": cfg}) is None
    assert mod.read({"trace": None, "config": cfg}) is None
