"""The traced sub-window: a ``torch.profiler`` trace over a short steady
stretch of a ``--trace 1`` run, read after the window has closed.

The device entries are told apart from the host's as ``chip_smoke.py``'s
``device_events`` tells them (copied here, so a change of the program
cannot move the yardstick): a ``record_function`` range and a schedule's
step marker also show as device entries, holding the wall time they span;
they are no device work, and a range has a host entry of the same name,
so every device entry whose name a host entry shares is left out.

The harness's own ranges (``pb.*``, put around its calls into each layer)
label the idle gaps: a gap takes the name of the innermost ``pb.*`` range
the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

WINDOW_RANGE = "pb.window"


def span(name: str):
    """A harness range around a call into a layer: a ``record_function``
    while a profiler records, else nothing."""
    import torch

    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@dataclass
class Trace:
    window_s: float  # the traced sub-window, by the host's clock
    busy_s: float  # union of the device's busy intervals in it
    ops: dict[str, tuple[float, int]]  # device op name -> (seconds, count)
    gaps: list[tuple[str, float]]  # (host range at the gap, seconds)

    def op_seconds(self, match: str) -> tuple[float, int]:
        """Device seconds and count of the ops whose name holds ``match``."""
        s = n = 0
        for name, (sec, cnt) in self.ops.items():
            if match in name:
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        by_gap: dict[str, float] = {}
        for label, sec in self.gaps:
            by_gap[label] = by_gap.get(label, 0.0) + sec
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:120], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in sorted(
                    by_gap.items(), key=lambda kv: -kv[1])[:top]]}


class SubWindow:
    """``with SubWindow(): ...`` profiles what runs inside, between two
    synchronisations of the card; :meth:`read` turns the trace into a
    :class:`Trace` (call it after the measured window has closed)."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def read(self) -> Trace:
        return read_events(_events(self.prof), self.wall_s)


@dataclass
class DeviceTotals:
    busy_s: float  # union of the device's busy intervals
    kernel_s: float  # summed kernel time
    copy_s: float  # summed copy and set time
    n_ops: int


class DeviceWindow:
    """The card's activity over a whole measured window: a profiler that
    records the device alone (no host operators, so the host pays only
    the tracing of its CUDA calls), started at the window's first call
    and stopped after the card has finished the last."""

    def __init__(self):
        self.prof = None

    def start(self) -> "DeviceWindow":
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def stop(self) -> DeviceTotals:
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return device_totals(_events(self.prof))


def device_totals(events: list["Event"]) -> DeviceTotals:
    """Busy union, kernel and copy seconds of the device entries (ranges
    and step markers left out, as :func:`read_events` leaves them)."""
    host_names = {e.name for e in events if not e.device}
    dev = [e for e in events if e.device and e.name not in host_names
           and "user_annotation" not in e.kind
           and not e.name.startswith("ProfilerStep")]
    copy = [e for e in dev
            if e.name.startswith(("Memcpy", "Memset"))]
    kernel_s = sum(e.end_ns - e.start_ns for e in dev) / 1e9
    copy_s = sum(e.end_ns - e.start_ns for e in copy) / 1e9
    busy = sum(b - a for a, b in _merge([(e.start_ns, e.end_ns)
                                         for e in dev])) / 1e9
    return DeviceTotals(busy, kernel_s - copy_s, copy_s, len(dev))


@dataclass
class Event:
    name: str
    device: bool
    start_ns: int
    end_ns: int
    kind: str = ""  # kineto's activity type, where it gives one


def _events(prof) -> list[Event]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else ""
        out.append(Event(e.name(), e.device_type() == cuda, e.start_ns(),
                         e.start_ns() + e.duration_ns(), str(kind)))
    return out


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_events(events: list[Event], wall_s: float) -> Trace:
    """The :class:`Trace` of a list of events. The sub-window is the host
    range ``pb.window``; device work is clipped to it."""
    host = [e for e in events if not e.device]
    host_names = {e.name for e in host}
    win = [e for e in host if e.name == WINDOW_RANGE]
    if not win:
        raise ValueError("the trace holds no pb.window range")
    w0, w1 = win[0].start_ns, win[0].end_ns
    dev = [e for e in events if e.device and e.name not in host_names
           and "user_annotation" not in e.kind
           and not e.name.startswith("ProfilerStep")]
    ops: dict[str, tuple[float, int]] = {}
    spans = []
    for e in dev:
        a, b = max(e.start_ns, w0), min(e.end_ns, w1)
        if b <= a:
            continue
        s, n = ops.get(e.name, (0.0, 0))
        ops[e.name] = (s + (b - a) / 1e9, n + 1)
        spans.append((a, b))
    merged = _merge(spans)
    busy = sum(b - a for a, b in merged) / 1e9

    # idle gaps, each named by the innermost harness range around its middle
    pb = sorted(((e.start_ns, e.end_ns, e.name) for e in host
                 if e.name.startswith("pb.") and e.name != WINDOW_RANGE),
                key=lambda r: r[1] - r[0])
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = next((n for s, t, n in pb if s <= mid <= t), "pb.outside")
        gaps.append((label, (b - a) / 1e9))

    return Trace(wall_s, busy, ops, gaps)
