"""The port's tracer (``repro_torch.utils.trace``) on the CPU: off without
a profiler, records under one, on the profiler's clock, bounded, one
session at a time; and the spans, marks and counters of the frame call,
the transfer engine's descriptors and the serving step."""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.accel.nullhop import NullHopExecutor
from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.configs import roshambo as roshambo_configs
from repro_torch.configs.registry import smoke_config
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.models.api import build_model
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request
from repro_torch.utils import trace

torch.set_num_threads(1)


def _profiling():
    """A CPU profiler session; the tracer sees it off first, so the
    session's records start clean."""
    assert not trace.enabled()
    return profile(activities=[ProfilerActivity.CPU])


def _by_seq(recs):
    return {r.seq: r for r in recs}


def test_off_records_nothing_and_returns_the_shared_null_context():
    before = trace.records(), trace.counters()
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", id=3)
    with trace.span("a") as got:
        assert got is None
        trace.mark("m", 0, 1, id=1)
        trace.count("wait.x")
    assert (trace.records(), trace.counters()) == before


def test_records_carry_names_parents_ids_and_worker_marks():
    def worker():
        trace.mark("worker.mark", time.time_ns(), time.time_ns() + 10,
                   id=9, parent=outer_seq[0], kind="w")

    outer_seq = []
    with _profiling():
        with trace.span("outer", id=7) as outer:
            outer_seq.append(outer.seq)
            with trace.span("inner"):
                trace.mark("inner.mark", time.time_ns(), time.time_ns())
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
            trace.count("wait.a")
            trace.count("wait.a", 2)
    recs = {r.name: r for r in trace.records()}
    assert set(recs) == {"outer", "inner", "inner.mark", "worker.mark"}
    o, i = recs["outer"], recs["inner"]
    assert o.parent is None and o.id == 7
    assert i.parent == o.seq and i.id == 7  # inherits the parent's id
    assert recs["inner.mark"].parent == i.seq and recs["inner.mark"].id == 7
    w = recs["worker.mark"]
    assert w.parent == o.seq and w.id == 9 and w.attrs == {"kind": "w"}
    assert w.thread != o.thread
    assert o.t0_ns <= i.t0_ns <= i.t1_ns <= o.t1_ns
    assert trace.counters() == {"wait.a": 3}


def test_span_agrees_with_the_profilers_range():
    with _profiling():  # the first range of a process costs its set-up
        with trace.span("warm"):
            pass
    with _profiling() as prof:
        with trace.span("agree.outer"):
            time.sleep(0.002)
            with trace.span("agree.inner"):
                time.sleep(0.001)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for rec in trace.records():
        e = events[rec.name]
        assert abs(e.start_ns() - rec.t0_ns) < 500_000, rec.name
        end = e.start_ns() + e.duration_ns()
        assert abs(end - rec.t1_ns) < 500_000, rec.name


def test_buffer_is_bounded_and_a_new_session_starts_clean(monkeypatch):
    monkeypatch.setattr(trace, "_records", collections.deque(maxlen=8))
    with _profiling():
        for i in range(20):
            with trace.span("s", id=i):
                pass
        trace.count("wait.a")
    recs = trace.records()
    assert [r.id for r in recs] == list(range(12, 20))
    assert trace.records() == recs  # kept after the session ends
    with trace.span("off"):  # seen off
        pass
    with _profiling():
        with trace.span("next"):
            pass
    assert [r.name for r in trace.records()] == ["next"]
    assert trace.counters() == {}


@pytest.mark.parametrize("profiling", [False, True])
def test_a_tally_sums_this_threads_counts_and_records_none(profiling):
    """What a captured step counts (``models/lm.py:DecodeGraph``) goes to
    the tally, profiler or not, and to no session; another thread's
    counts, and counts after the block, are recorded as ever."""
    other = threading.Thread(target=trace.count, args=("other",))
    with _profiling() if profiling else contextlib.nullcontext():
        trace.count("before")
        with trace.tally() as t:
            trace.count("attn.decode", 2)
            trace.count("attn.decode")
            trace.count("attn.decode_latent", 27)
            other.start()
            other.join()
        trace.count("after")
        got = trace.counters()
    assert t == {"attn.decode": 3, "attn.decode_latent": 27}
    if profiling:
        assert got == {"before": 1, "other": 1, "after": 1}

def test_done_event_marks_the_wake_of_its_waiter():
    done = trace.Done()
    with _profiling():
        done.tag = trace.tag(cls="layer", management="interrupt", bytes=4)
        done.set()
        time.sleep(0.001)
        t_wait = time.time_ns()
        assert done.wait(1)
        trace.woke(done, t_wait)
    wake = [r for r in trace.records() if r.name == "xfer.wake"]
    assert len(wake) == 1
    # set before the wait began: the wake runs from the wait's start
    assert wake[0].t0_ns == t_wait and wake[0].id == done.tag.id
    assert wake[0].attrs == {"cls": "layer", "management": "interrupt",
                             "bytes": 4}


@pytest.fixture(scope="module")
def smoke_cnn():
    cnn = RoShamBoCNN(roshambo_configs.smoke_config())
    params = cnn.init(torch.Generator().manual_seed(0), device="cpu")
    frame = np.random.default_rng(0).random((1, 16, 16, 1),
                                            dtype=np.float32)
    return cnn, params, frame


def test_frame_call_spans_layers_descriptors_and_sparsity(smoke_cnn):
    cnn, params, frame = smoke_cnn
    ex = NullHopExecutor(cnn, TransferPolicy.kernel_level(), device="cpu")
    try:
        ex.run_frame(params, frame)
        with _profiling():
            res = ex.run_frame(params, frame)
    finally:
        ex.close()
    recs = trace.records()
    by = _by_seq(recs)
    frames = [r for r in recs if r.name == "frame"]
    assert len(frames) == 1 and frames[0].id == ex.calls == 2
    f = frames[0]
    children = collections.Counter(r.name for r in recs if r.parent == f.seq)
    n_layers = len(cnn.cfg.layers)
    assert children["frame.layer"] == n_layers
    assert children["frame.sparsity"] == children["frame.head"] == 1
    for name in ("frame.tx", "frame.compute", "frame.rx"):
        phases = [r for r in recs if r.name == name]
        assert all(r.id == f.id for r in phases)
    # the input, each layer's params and each layer's output: one
    # descriptor each, queued and woken once, under the call's spans
    n_transfers = 1 + 2 * n_layers
    for name in ("xfer.queue", "xfer.service", "xfer.deliver", "xfer.wake"):
        marks = [r for r in recs if r.name == name]
        assert len(marks) == n_transfers, name
        assert all(by[r.parent].name in ("xfer.tx", "xfer.rx")
                   and by[r.parent].id == f.id for r in marks), name
        assert all(r.attrs["management"] == "interrupt" for r in marks)
    queue = {r.id: r for r in recs if r.name == "xfer.queue"}
    wake = {r.id: r for r in recs if r.name == "xfer.wake"}
    assert set(queue) == set(wake)
    assert all(queue[i].t1_ns <= wake[i].t1_ns for i in queue)
    assert all(r.id == f.id for r in recs if r.name.startswith("frame."))
    # one read of the call's zero counts, taken where each streamed layer
    # left its fmap
    assert trace.counters()["wait.sparsity"] == 1
    assert trace.counters()["sparsity.fmaps"] == n_layers
    assert trace.counters()["wait.ticket"] == n_transfers
    # the call's wall is taken around the whole call, span and all
    assert res.timing.frame_s * 1e9 >= f.dur_ns
    assert res.timing.frame_s >= res.timing.layers_s > 0


@pytest.mark.parametrize("policy,queued", [
    ("user_level_polling", False), ("user_level_scheduled", True)])
def test_polling_and_scheduled_mark_the_phases_they_have(policy, queued):
    eng = TransferEngine(getattr(TransferPolicy, policy)(), device="cpu")
    try:
        with _profiling():
            with trace.span("caller"):
                eng.tx(np.arange(64, dtype=np.float32))
    finally:
        eng.close()
    recs = trace.records()
    names = collections.Counter(r.name for r in recs)
    mgmt = getattr(TransferPolicy, policy)().management.value
    svc = [r for r in recs if r.name == "xfer.service"]  # one a chunk
    assert svc and names["xfer.tx"] == 1
    assert names["xfer.queue"] == len(svc) * int(queued)
    assert not names["xfer.wake"] and not names["xfer.deliver"]
    assert sum(r.attrs["bytes"] for r in svc) == 256
    assert all(r.attrs["cls"] == "layer" and r.attrs["management"] == mgmt
               for r in svc)
    assert {_by_seq(recs)[r.parent].name for r in svc} == {"xfer.tx"}


def test_serving_step_spans_admission_with_the_request_id():
    m = build_model(smoke_config("granite-moe-1b-a400m").replace(
        dtype="float32"))
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(), device="cpu",
                              runtime=rt)
    eng = ContinuousBatchingEngine(m, params, n_slots=2, max_seq=32,
                                   transfer=transfer)
    rng = np.random.default_rng(0)
    try:
        with _profiling():
            assert eng.submit(Request(
                rid=41, prompt=rng.integers(0, m.cfg.vocab, 9).astype(
                    np.int32), max_new_tokens=3)).admitted
            eng.step()
            eng.step()
    finally:
        eng.close()
        transfer.close()
        rt.close()
    recs = trace.records()
    by = _by_seq(recs)
    prefill = [r for r in recs if r.name == "serve.prefill"]
    assert len(prefill) == 1 and prefill[0].id == 41
    admit = by[prefill[0].parent]
    assert admit.name == "serve.admit"
    assert by[admit.parent].name == "serve.step"
    for name in ("serve.first_token", "serve.splice", "serve.queue",
                 "serve.request"):
        got = [r for r in recs if r.name == name]
        assert [r.id for r in got] == [41], name
    steps = [r for r in recs if r.name == "serve.step"]
    assert len(steps) == 2
    for name in ("serve.admit", "serve.decode", "serve.token_rx",
                 "serve.retire"):
        got = [r for r in recs if r.name == name]
        assert len(got) == 2 and {by[r.parent].name for r in got} == {
            "serve.step"}, name
    decode = [r for r in recs if r.name == "lm.decode"]
    assert {by[r.parent].name for r in decode} == {"serve.decode"}
    assert by[next(r for r in recs if r.name == "lm.prefill").parent] \
        is prefill[0]
    attn = [r for r in recs if r.name == "attn.cache"]
    assert len(attn) == 3 * m.cfg.n_layers
    assert {r.name for r in recs} >= {"moe.dispatch", "moe.experts",
                                      "moe.combine", "xfer.wake"}
    assert trace.counters()["wait.first_token"] == 1
