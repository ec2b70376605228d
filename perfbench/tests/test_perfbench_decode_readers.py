"""The readers of the decode graph's replays and of the decode-attention
kernel's device time, on hand-made records and traces: each reads the
right number, and nothing where the program has no such counter, the
trace's launches disagree with it, or there is no tracer."""

from __future__ import annotations

import sys

import pytest

from perfbench.lib import spec
from perfbench.lib.trace import Trace
from perfbench.tests import helpers  # noqa: F401  (the port on the path)

from repro_torch.utils import trace

MS = 1_000_000  # ns
SPLIT = "void (anonymous namespace)::decode_attention_split_kernel<64, 2>"
MERGE = "void (anonymous namespace)::decode_attention_merge_kernel<64>"


def _steps(n: int) -> list:
    return [trace.Record("serve.step", i * 200 * MS, i * 200 * MS + 150 * MS,
                         None, 1, None, i + 1) for i in range(n)]


@pytest.fixture
def program(monkeypatch):
    """Puts hand-made records and counters in the tracer's place."""
    def put(recs, counts):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


def test_the_graph_share(program):
    read = spec.load_module("metrics", "decode_graph_share.serve").read
    program(_steps(4), {"serve.graph_replay": 3, "attn.decode": 72})
    assert read({}) == pytest.approx(75.0)
    program(_steps(4), {"attn.decode": 96})  # a program that replays none
    assert read({}) is None
    program([], {"serve.graph_replay": 3})
    assert read({}) is None


def test_the_decode_attention_time(program):
    read = spec.load_module("metrics", "attn_decode_us.serve").read
    ops = {SPLIT: (0.004, 96), MERGE: (0.0002, 96), "gemv": (1.0, 9)}
    tr = Trace(1.0, 0.5, ops, [])
    program(_steps(4), {"attn.decode": 96})
    assert read({"trace": tr}) == pytest.approx(1050.0)
    # a launch the program did not count, none at all, no trace: nothing
    program(_steps(4), {"attn.decode": 95})
    assert read({"trace": tr}) is None
    program(_steps(4), {})
    assert read({"trace": Trace(1.0, 0.5, {}, [])}) is None
    assert read({"trace": None}) is None


@pytest.mark.parametrize("metric", ["decode_graph_share.serve",
                                    "attn_decode_us.serve"])
def test_nothing_from_a_program_without_the_tracer(monkeypatch, metric):
    import repro_torch.utils

    monkeypatch.delattr(repro_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    tr = Trace(1.0, 0.5, {SPLIT: (0.004, 96), MERGE: (0.0002, 96)}, [])
    assert spec.load_module("metrics", metric).read({"trace": tr}) is None
