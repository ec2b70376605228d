"""The reader of the MoE layers' rows a seat, on hand-made counters: rows
over seats where the program counts both, nothing where it counts
neither, serves no seat, or has no tracer."""

from __future__ import annotations

import sys

import pytest

from perfbench.lib import spec
from perfbench.tests import helpers  # noqa: F401  (the port on the path)

from repro_torch.utils import trace

METRIC = "moe_rows_per_seat.serve"


@pytest.fixture
def counters(monkeypatch):
    """Puts hand-made counters in the tracer's place."""
    def put(counts):
        monkeypatch.setattr(trace, "counters", lambda: dict(counts))
    return put


@pytest.mark.parametrize("counts,want", [
    # rag's decode steps (72 experts of 64 seats, 640 seats a layer) and
    # one grouped 1,858-token prefill, over 20 layers
    ({"moe.rows": 20 * (8 * 72 * 64 + 18_580),
      "moe.seats": 20 * (8 * 640 + 18_580)}, 55_444 / 23_700),
    ({"moe.rows": 4608, "moe.seats": 640}, 7.2),  # decode steps alone
    ({"moe.rows": 18_580, "moe.seats": 18_580, "attn.decode": 2}, 1.0),
])
def test_rows_over_seats(counters, counts, want):
    counters(counts)
    assert spec.load_module("metrics", METRIC).read({}) == pytest.approx(want)


@pytest.mark.parametrize("counts", [
    {}, {"attn.decode": 96}, {"moe.rows": 4608}, {"moe.seats": 640},
    {"moe.rows": 0, "moe.seats": 0}])
def test_nothing_without_both_counters(counters, counts):
    counters(counts)
    assert spec.load_module("metrics", METRIC).read({}) is None


def test_nothing_from_a_program_without_the_tracer(monkeypatch):
    import repro_torch.utils

    monkeypatch.delattr(repro_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.trace", None)
    assert spec.load_module("metrics", METRIC).read({}) is None
