"""Opt-in runtime lock validation: the dynamic half of the static analyzer.

``make_lock`` / ``make_rlock`` / ``make_condition`` are drop-in factories the
core modules use instead of bare ``threading.Lock()`` etc. In production they
return the plain threading primitive (zero overhead). When
``REPRO_VALIDATE_LOCKS=1`` (or after :func:`enable`), they return a
:class:`ValidatedLock` that:

- records every (held -> acquired) pair into a process-global order graph and
  raises :class:`LockOrderViolation` the moment a real acquisition would
  close a cycle — the dynamic evidence backing the static lock-order rule;
- tracks the per-thread held stack so ``assert_held`` can verify
  ``# requires-lock:`` contracts at runtime (guarded-by access from the
  declared owner).

The stress CI lane exports the flag, so every stress run doubles as a
lock-discipline check. Only the stdlib is imported here: ``repro_torch.core``
modules import this without creating an import cycle.
"""
from __future__ import annotations

import os
import threading

_FLAG = "REPRO_VALIDATE_LOCKS"
_forced: bool | None = None


def enabled() -> bool:
    if _forced is not None:
        return _forced
    return os.environ.get(_FLAG, "") not in ("", "0")


def enable(on: bool = True) -> None:
    """Programmatic override (tests); ``enable(None)`` restores env control."""
    global _forced
    _forced = on


class LockOrderViolation(RuntimeError):
    """A real acquisition closed a cycle in the observed lock-order graph."""


class LockAssertionError(RuntimeError):
    """A requires-lock function ran without its declared lock held."""


_tls = threading.local()


def _held() -> list[str]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


class _OrderGraph:
    """Process-global observed lock-order graph. Leaf lock: nothing else is
    ever acquired while ``_mu`` is held."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: dict[str, set[str]] = {}
        self.violations: list[str] = []

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()
            self.violations.clear()

    def edges(self) -> dict[str, set[str]]:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def on_acquire(self, held: list[str], name: str) -> None:
        if not held:
            return
        with self._mu:
            new_edge = False
            for h in held:
                if h == name:
                    continue
                succ = self._edges.setdefault(h, set())
                if name not in succ:
                    succ.add(name)
                    new_edge = True
            if not new_edge:
                return
            # a cycle exists iff `name` now reaches one of the held locks
            targets = set(held) - {name}
            path = self._find_path(name, targets)
            if path is not None:
                msg = (f"lock-order inversion: acquiring {name} while holding "
                       f"{held}; prior order {' -> '.join(path)}")
                self.violations.append(msg)
                raise LockOrderViolation(msg)

    def _find_path(self, start: str, targets: set[str]) -> list[str] | None:
        stack = [(start, [start])]
        seen = {start}
        while stack:
            node, path = stack.pop()
            for nxt in self._edges.get(node, ()):
                if nxt in targets:
                    return path + [nxt]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None


order_graph = _OrderGraph()


class ValidatedLock:
    """Lock wrapper recording per-thread acquisition order.

    Works as the backing lock of a ``threading.Condition`` (only ``acquire``
    and ``release`` are required; the Condition fallbacks handle the rest).
    """

    def __init__(self, name: str, factory=threading.Lock, reentrant: bool = False):
        self._name = name
        self._reentrant = reentrant
        self._inner = factory()

    @property
    def name(self) -> str:
        return self._name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if not (self._reentrant and self._name in held):
            order_graph.on_acquire(held, self._name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            held.append(self._name)
        return got

    def release(self) -> None:
        held = _held()
        # remove the most recent occurrence (reentrant locks stack)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == self._name:
                del held[i]
                break
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str):
    return ValidatedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    return (ValidatedLock(name, factory=threading.RLock, reentrant=True)
            if enabled() else threading.RLock())


def make_condition(name: str):
    return (threading.Condition(ValidatedLock(name))
            if enabled() else threading.Condition())


def held_names() -> tuple[str, ...]:
    return tuple(_held())


def assert_held(lock, what: str = "") -> None:
    """Runtime check for ``# requires-lock:`` functions. No-op unless
    validation is enabled AND the lock is a validated primitive."""
    if not enabled():
        return
    inner = getattr(lock, "_lock", lock)  # unwrap Condition
    if not isinstance(inner, ValidatedLock):
        return
    if inner.name not in _held():
        raise LockAssertionError(
            f"{what or 'caller'} requires {inner.name} but this thread holds "
            f"{_held() or 'no locks'}")
