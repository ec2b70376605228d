"""The readers of the program's own spans and counters
(``repro_torch.utils.trace``), on hand-made records: each reads the right
number, and nothing where there are no records or no tracer."""

from __future__ import annotations

import sys

import pytest

from perfbench.lib import spec
from perfbench.tests import helpers  # noqa: F401  (the port on the path)

from repro_torch.utils import trace

US = 1_000  # ns
MS = 1_000_000

FRAME = ["xfer_queue_us.frame", "xfer_wake_us.frame", "sparsity_ms.frame",
         "host_waits.frame"]
SERVE = ["admit_ms.serve", "decode_dispatch_ms.serve", "token_wait_us.serve",
         "host_waits.serve"]


def _rec(name, t0, dur, seq, parent=None, id=None):
    return trace.Record(name, t0, t0 + dur, parent, 1, id, seq)


def _frames() -> list:
    """Two calls: descriptors queued 10 and 30 us in the first, 20 in the
    second; woken 4, 6 and 8 us; sparsity 1.5 and 2.5 ms."""
    return [
        _rec("frame", 0, 10 * MS, 1, id=1),
        _rec("xfer.tx", 0, 1 * MS, 2, parent=1, id=1),
        _rec("xfer.queue", 10, 10 * US, 3, parent=2, id=11),
        _rec("xfer.wake", 20, 4 * US, 4, parent=2, id=11),
        _rec("xfer.queue", 30, 30 * US, 5, parent=2, id=12),
        _rec("xfer.wake", 40, 6 * US, 6, parent=2, id=12),
        _rec("frame.sparsity", 5 * MS, 1.5 * MS, 7, parent=1, id=1),
        _rec("frame", 10 * MS, 10 * MS, 8, id=2),
        _rec("xfer.queue", 11 * MS, 20 * US, 9, id=13),
        _rec("xfer.wake", 12 * MS, 8 * US, 10, id=13),
        _rec("frame.sparsity", 15 * MS, 2.5 * MS, 11, parent=8, id=2),
    ]


def _steps() -> list:
    """Four steps: admissions of 6 and 2 ms, decodes of 100 ms each,
    token RX of 2,000 us each."""
    recs = []
    for i in range(4):
        t = i * 200 * MS
        s = 10 * i
        recs.append(_rec("serve.step", t, 150 * MS, s))
        recs.append(_rec("serve.admit", t, (6, 2, 0, 0)[i] * MS, s + 1, s))
        recs.append(_rec("lm.decode", t + 10 * MS, 100 * MS, s + 2, s))
        recs.append(_rec("serve.token_rx", t + 120 * MS, 2000 * US, s + 3, s))
    return recs


@pytest.fixture
def program(monkeypatch):
    """Puts hand-made records and counters in the tracer's place."""
    def put(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


@pytest.mark.parametrize("metric,value", [
    ("xfer_queue_us.frame", 20.0), ("xfer_wake_us.frame", 6.0),
    ("sparsity_ms.frame", 2.0), ("host_waits.frame", 33.0)])
def test_frame_readers(program, metric, value):
    program(_frames(), {"wait.ticket": 22, "wait.copy": 22,
                        "wait.compute": 10, "wait.sparsity": 12,
                        "other": 1000})
    got = spec.load_module("metrics", metric).read({})
    assert got == pytest.approx(value)


@pytest.mark.parametrize("metric,value", [
    ("admit_ms.serve", 2.0), ("decode_dispatch_ms.serve", 100.0),
    ("token_wait_us.serve", 2000.0), ("host_waits.serve", 66.5)])
def test_serving_readers(program, metric, value):
    program(_steps(), {"wait.ticket": 256, "wait.copy": 4,
                       "wait.first_token": 6, "other": 1000})
    got = spec.load_module("metrics", metric).read({})
    assert got == pytest.approx(value)


@pytest.mark.parametrize("metric", FRAME + SERVE)
def test_nothing_without_records(program, metric):
    program([], {"wait.ticket": 3})
    assert spec.load_module("metrics", metric).read({}) is None


@pytest.mark.parametrize("metric", FRAME + SERVE)
def test_nothing_from_the_other_cells_records(program, metric):
    # a frame reader over serving steps, and a serving reader over frames
    program(_steps() if metric in FRAME else _frames(), {"wait.ticket": 3})
    assert spec.load_module("metrics", metric).read({}) is None


@pytest.mark.parametrize("metric", FRAME + SERVE)
def test_nothing_from_a_program_without_the_tracer(monkeypatch, metric):
    import repro_torch.utils

    monkeypatch.delattr(repro_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    assert spec.load_module("metrics", metric).read({}) is None
