"""The port's tracer: spans, marks and counters, recorded while a
``torch.profiler`` session records.

An operator turns tracing on by running the profiler around the code of
interest; nothing else turns it on. While no profiler records, every site
costs one flag read: :func:`span` returns a shared null context and
:func:`mark` / :func:`count` return at once (a count also reads
whether a :func:`tally` is open on its thread).

While a profiler records:

- :func:`span` opens a ``record_function`` range of the same name (so a
  span on the main thread sits beside the kernels in an exported trace)
  and keeps a :class:`Record` of it. A range opened on another thread
  does not reach the profiler's events, so the records are the complete
  account: the transfer runtime's workers keep theirs with :func:`mark`.
- :func:`mark` keeps an interval the caller stamped itself, for work that
  starts on one thread and ends on another. A stamp the program already
  took on ``time.monotonic`` or ``time.perf_counter`` is converted by one
  offset taken when this module loads (:func:`mono_ns`, :func:`perf_ns`).
- :func:`count` adds to a counter.

Every record is on the profiler's clock, Unix-epoch nanoseconds
(``time.time_ns()``), so records line up with the profiler's events. A
record's ``parent`` is the ``seq`` of the innermost span open on its
thread (or the one a mark names); a span given no ``id`` takes its
parent's. :func:`records` and :func:`counters` return the newest
profiling session's: a session starts with the first record after the
tracer was seen off (a site reached, or :func:`enabled` called, while no
profiler recorded). Both are held in bounded buffers (the oldest entries
go first); appends are safe from any thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Any, NamedTuple

from torch.autograd import profiler as _profiler

BUFFER = 1 << 17  # records (and counter entries) kept of a session


class Record(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    parent: int | None  # seq of the enclosing span
    thread: int
    id: Any  # the call, request or descriptor the record belongs to
    seq: int
    attrs: dict | None = None

    @property
    def dur_ns(self) -> int:
        return self.t1_ns - self.t0_ns


_records: "collections.deque[Record]" = collections.deque(maxlen=BUFFER)
_counts: "collections.deque[tuple[str, int]]" = collections.deque(
    maxlen=BUFFER)
_seq = itertools.count(1)  # record numbers
_ids = itertools.count(1)  # descriptor numbers
_seen_off = True
_local = threading.local()
_NULL = contextlib.nullcontext()

_MONO_NS = time.time_ns() - time.monotonic_ns()
_PERF_NS = time.time_ns() - time.perf_counter_ns()


def mono_ns(t: float) -> int:
    """A ``time.monotonic()`` stamp on the profiler's clock."""
    return int(t * 1e9) + _MONO_NS


def perf_ns(t: float) -> int:
    """A ``time.perf_counter()`` stamp on the profiler's clock."""
    return int(t * 1e9) + _PERF_NS


def enabled() -> bool:
    """Whether a profiler records now."""
    global _seen_off
    if _profiler._is_profiler_enabled:
        return True
    _seen_off = True
    return False


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _top() -> "_Span | None":
    s = getattr(_local, "stack", None)
    return s[-1] if s else None


def _fresh() -> bool:
    """Starts a new session where the tracer was seen off since the last
    record; False where the profiler stopped after the caller's stamp."""
    global _seen_off
    if _seen_off:
        if not _profiler._is_profiler_enabled:
            return False
        _seen_off = False
        _records.clear()
        _counts.clear()
    return True


def _append(rec: Record) -> None:
    if _fresh():
        _records.append(rec)


class _Span:
    __slots__ = ("name", "id", "seq", "parent", "t0", "rf")

    def __init__(self, name: str, id: Any):
        self.name = name
        self.id = id

    def __enter__(self) -> "_Span":
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.seq if top is not None else None
        if self.id is None and top is not None:
            self.id = top.id
        self.seq = next(_seq)
        stack.append(self)
        self.t0 = time.time_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        t1 = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _append(Record(self.name, self.t0, t1, self.parent,
                       threading.get_ident(), self.id, self.seq))
        return False


def span(name: str, id: Any = None):
    """``with span(name, id): ...`` records the block as ``name``."""
    global _seen_off
    if not _profiler._is_profiler_enabled:
        _seen_off = True
        return _NULL
    return _Span(name, id)


def mark(name: str, t0_ns: int, t1_ns: int, id: Any = None,
         parent: int | None = None, **attrs) -> None:
    """Records an interval stamped by the caller. With no ``parent`` it
    takes the innermost span open on this thread (and its ``id`` where
    none is given)."""
    if not enabled():
        return
    if parent is None:
        top = _top()
        if top is not None:
            parent = top.seq
            if id is None:
                id = top.id
    _append(Record(name, t0_ns, t1_ns, parent, threading.get_ident(), id,
                   next(_seq), attrs or None))


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` (inside :func:`tally` on this
    thread, to the tally)."""
    into = getattr(_local, "tally", None)
    if into is not None:
        into[name] = into.get(name, 0) + n
    elif enabled() and _fresh():
        _counts.append((name, n))


@contextlib.contextmanager
def tally():
    """``with tally() as t:`` sums into the dict ``t`` what this thread
    counts inside the block, whether a profiler records or not, and
    records none of it: for work captured now (a CUDA graph) that runs
    later, whose replays add ``t`` again."""
    outer = getattr(_local, "tally", None)
    _local.tally = into = {}
    try:
        yield into
    finally:
        _local.tally = outer


class Tag(NamedTuple):
    """What the marks of one descriptor carry: its number, the span that
    submitted it, and its attributes (class, management, bytes)."""

    id: int
    parent: int | None
    attrs: dict

    def mark(self, name: str, t0_ns: int, t1_ns: int) -> None:
        mark(name, t0_ns, t1_ns, self.id, self.parent, **self.attrs)


def tag(**attrs) -> Tag:
    """A new descriptor number, under the innermost span open on this
    thread."""
    top = _top()
    return Tag(next(_ids), top.seq if top is not None else None, attrs)


class Done(threading.Event):
    """A completion event that, while a profiler records, stamps when it
    is set, so that the thread it wakes can mark the hand-off
    (:func:`woke`). ``tag`` is the :class:`Tag` of what it completes."""

    def __init__(self):
        super().__init__()
        self.t_set_ns = 0
        self.tag: Tag | None = None

    def set(self) -> None:
        if _profiler._is_profiler_enabled:
            self.t_set_ns = time.time_ns()
        super().set()


def woke(done: threading.Event, t_wait_ns: int) -> None:
    """After ``done.wait()``, begun at ``t_wait_ns``, returned: marks
    ``xfer.wake`` from the later of ``done``'s setting and the wait's
    start until now."""
    tag_ = getattr(done, "tag", None)
    if tag_ is None or not done.t_set_ns:
        return
    tag_.mark("xfer.wake", max(done.t_set_ns, t_wait_ns), time.time_ns())


def records() -> list[Record]:
    """The newest session's records, oldest first."""
    return list(_records)


def counters() -> dict[str, int]:
    """The newest session's counters."""
    out: dict[str, int] = {}
    for name, n in list(_counts):
        out[name] = out.get(name, 0) + n
    return out
