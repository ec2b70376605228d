"""Deterministic fault injection for the transfer stack.

The paper's kernel-level driver argument is a *safety* argument: interrupt
management exists so the OS survives a misbehaving bus while still
scheduling frame collection. This module is the misbehaving bus. It is one
half of the fault story, and the split is deliberate:

- **Injection (this module)** — :class:`FaultInjector` wraps
  :class:`~repro_torch.core.transfer.TransferEngine` through the existing
  ``engine_factory`` seam of
  :class:`~repro_torch.core.channels.ChannelGroup` /
  :class:`~repro_torch.core.adaptive.AdaptiveChannelGroup`, so faults appear
  exactly where a real flaky DMA channel would: inside ``_one`` (the
  descriptor body) and at submit time. A :class:`FaultPlan` (seed +
  :class:`FaultSpec` schedule) makes every run reproducible: per-channel
  RNG streams and op counters mean the injected (channel, op, kind)
  sequence depends only on the seed and the workload, never on thread
  interleaving across channels. The injector knows NOTHING about
  recovery.
- **Recovery (the production stack)** — bounded ticket waits and the
  runtime timeout scan live in ``repro_torch.core.runtime`` / ``transfer``;
  retry-on-sibling, quarantine and probe-based un-quarantine live in
  ``repro_torch.core.channels`` (tuned by :class:`RecoveryConfig`);
  replanning around a reduced channel set lives in
  ``repro_torch.core.adaptive``. None of
  it imports this module's injection machinery — production code paths
  heal real faults the same way they heal injected ones.

Fault kinds (:class:`FaultSpec.kind`):

``delay``
    completion held ``delay_s`` before the payload moves (late IRQ).
``drop``
    descriptor held ``hold_s`` then *fails* without ever moving the
    payload — the repro of a completion that never fires. Bounded on
    purpose: an unboundedly-stuck in-service descriptor is the one fault
    no software layer can unstick (see
    :meth:`~repro_torch.core.runtime.TransferRuntime.scan_timeouts`); real
    recovery comes from the caller's bounded wait + sibling retry, which
    this models faithfully. An RX drop never writes the caller's buffer.
``submit_error``
    transient :class:`InjectedFault` raised at submit time (bus NAK).
``corrupt``
    the landed RX payload — host bytes — is bit-flipped (caught by
    ``TransferPolicy.checksum``). RX only — never mutates device memory,
    so a retry re-reads clean bytes.
``stall``
    every op on the channel slows by ``stall_s`` while active — the
    silently-degraded channel the quarantine machinery exists for.
    :meth:`FaultInjector.stall` toggles a manual stall for benchmarks.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.analysis.validated import assert_held, make_lock
from repro_torch.core.runtime import TransferFaultError
from repro_torch.core.transfer import TransferEngine

_KINDS = ("delay", "drop", "submit_error", "corrupt", "stall")


class InjectedFault(TransferFaultError):
    """The error a ``drop``/``submit_error`` injection surfaces as.

    Subclasses :class:`~repro_torch.core.runtime.TransferFaultError`, so the
    channel layer's retry predicate treats injected faults exactly like
    organic ones."""


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault pattern. All matching specs fire per op (an op
    is one descriptor body execution on one channel)."""

    kind: str
    p: float = 1.0                 # per-op injection probability
    channel: int | None = None     # restrict to one channel (None = any)
    direction: str | None = None   # "tx" / "rx" / None = both
    after_ops: int = 0             # channel warms up this many ops first
    max_injections: int | None = None  # cap total firings of this spec
    delay_s: float = 0.05          # ``delay``: completion held this long
    hold_s: float = 0.25           # ``drop``: held this long, then fails
    stall_s: float = 0.02          # ``stall``: per-op slowdown

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {_KINDS}")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {self.p}")
        if self.direction not in (None, "tx", "rx"):
            raise ValueError(f"direction must be tx/rx/None, "
                             f"got {self.direction!r}")
        if self.kind == "corrupt":
            if self.direction == "tx":
                raise ValueError("corrupt is RX-only (verified at the RX "
                                 "landing; TX corruption would mutate "
                                 "device-side state)")
            # pin the direction so a direction-agnostic spec never burns
            # a max_injections draw on a TX op where corruption is a no-op
            object.__setattr__(self, "direction", "rx")


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, reproducible fault schedule: same seed + same workload →
    identical (channel, op, kind) event sequence."""

    seed: int = 0
    specs: tuple[FaultSpec, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "specs", tuple(self.specs))


class FaultInjector:
    """Installs a :class:`FaultPlan` behind the ``engine_factory`` seam.

    Channel identity is engine **creation order** (the order ChannelGroup
    builds its rings, which is stripe order), so a spec's ``channel=0``
    always means the group's first ring — across reruns and across plan
    generations of an adaptive group. ``events`` is the injection ledger
    the seeded-determinism contract is asserted on."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = make_lock("FaultInjector._lock")
        self._n_engines = 0  # guarded-by: _lock
        self._rngs: dict[int, random.Random] = {}  # guarded-by: _lock
        self._ops: dict[int, int] = {}  # guarded-by: _lock
        self._injected: dict[int, int] = {}  # guarded-by: _lock (per-spec firings)
        self._manual_stall: dict[int, float] = {}  # guarded-by: _lock
        # (channel, op_index, kind, direction, stage) in injection order
        self.events: list[tuple[int, int, str, str, str]] = []  # guarded-by: _lock

    # -- scheduling ----------------------------------------------------------
    def _rng(self, channel: int) -> random.Random:  # requires-lock: _lock
        assert_held(self._lock, "_rng")
        rng = self._rngs.get(channel)
        if rng is None:
            rng = self._rngs[channel] = random.Random(
                (self.plan.seed << 16) ^ (channel + 1))
        return rng

    def _decide(self, channel: int, direction: str,
                stage: str) -> list[FaultSpec]:
        """Advance the channel's op counter and return the specs that fire
        for this op. One lock-serialized draw per (op, matching spec):
        deterministic given the per-channel op/direction sequence."""
        want_submit = stage == "submit"
        with self._lock:
            op = self._ops.get(channel, 0)
            self._ops[channel] = op + 1
            rng = self._rng(channel)
            hits: list[FaultSpec] = []
            for si, spec in enumerate(self.plan.specs):
                if (spec.kind == "submit_error") != want_submit:
                    continue
                if spec.channel is not None and spec.channel != channel:
                    continue
                if spec.direction is not None and spec.direction != direction:
                    continue
                if op < spec.after_ops:
                    continue
                if (spec.max_injections is not None
                        and self._injected.get(si, 0) >= spec.max_injections):
                    continue
                if rng.random() >= spec.p:
                    continue
                self._injected[si] = self._injected.get(si, 0) + 1
                self.events.append((channel, op, spec.kind, direction, stage))
                hits.append(spec)
            return hits

    # -- manual control (benchmarks) ----------------------------------------
    def stall(self, channel: int, on: bool = True,
              stall_s: float = 0.02) -> None:
        """Toggle a manual per-op stall on one channel — the benchmark's
        1-of-N degraded channel, independent of the seeded schedule."""
        with self._lock:
            if on:
                self._manual_stall[channel] = float(stall_s)
            else:
                self._manual_stall.pop(channel, None)

    def _stall_for(self, channel: int) -> float:
        with self._lock:
            return self._manual_stall.get(channel, 0.0)

    @property
    def n_engines(self) -> int:
        with self._lock:
            return self._n_engines

    # -- the engine seam -----------------------------------------------------
    @staticmethod
    def _corrupt_landed(r: Any, out: np.ndarray | None) -> Any:
        """Bit-flip the landed RX bytes. With ``out=`` the caller's buffer
        is corrupted in place (that IS the landing); otherwise the result
        is copied first and the copy flipped, so nothing a retry re-reads
        (on a CPU engine the "device" tensor is host memory) ever changes."""
        if out is not None:
            buf = out.reshape(-1).view(np.uint8)
            if buf.size:
                buf[0] ^= 0xFF
            return out
        arr = np.array(r, copy=True)
        flat = arr.reshape(-1).view(np.uint8)
        if flat.size:
            flat[0] ^= 0xFF
        return arr

    def engine_factory(self, base: type = TransferEngine):
        """An ``engine_factory(policy, **kw)`` callable for ChannelGroup /
        AdaptiveChannelGroup: each engine it builds is a ``base`` subclass
        whose descriptor bodies consult this injector. ``base`` may itself
        be a modelled-timing engine subclass (benchmarks compose the
        injector OVER the drift model)."""
        injector = self

        class _FaultEngine(base):  # type: ignore[misc, valid-type]
            _fault_channel: int = -1

            def _one(self, payload, direction, out=None):
                ch = self._fault_channel
                stall_s = injector._stall_for(ch)
                if stall_s > 0.0:
                    time.sleep(stall_s)
                hits = injector._decide(ch, direction, "op")
                for spec in hits:
                    if spec.kind == "delay":
                        time.sleep(spec.delay_s)
                    elif spec.kind == "stall":
                        time.sleep(spec.stall_s)
                    elif spec.kind == "drop":
                        # held, then fails WITHOUT moving the payload: an
                        # RX drop must never write the caller's buffer (a
                        # late landing would corrupt a retried result).
                        time.sleep(spec.hold_s)
                        raise InjectedFault(
                            f"dropped completion (channel {ch}, "
                            f"{direction})")
                r = super()._one(payload, direction, out)
                for spec in hits:
                    if spec.kind == "corrupt" and direction == "rx":
                        r = injector._corrupt_landed(r, out)
                return r

            def _maybe_submit_error(self, direction: str) -> None:
                for spec in injector._decide(self._fault_channel, direction,
                                             "submit"):
                    raise InjectedFault(
                        f"transient submit error (channel "
                        f"{self._fault_channel}, {direction})")

            # the injection seam passes ``priority``/``qos`` through
            # untouched: resolution (and any deprecation warning) stays in
            # the wrapped engine, attributed to the original caller.
            def tx(self, host_array, priority=None, *, qos=None):
                self._maybe_submit_error("tx")
                return super().tx(host_array, priority=priority, qos=qos)

            def rx(self, device_arrays, out=None, priority=None, *,
                   qos=None):
                self._maybe_submit_error("rx")
                return super().rx(device_arrays, out=out,
                                  priority=priority, qos=qos)

            def tx_async(self, host_array, callback=None, layout=None,
                         priority=None, *, qos=None):
                self._maybe_submit_error("tx")
                return super().tx_async(host_array, callback=callback,
                                        layout=layout, priority=priority,
                                        qos=qos)

            def rx_async(self, device_arrays, callback=None, out=None,
                         priority=None, *, qos=None):
                self._maybe_submit_error("rx")
                return super().rx_async(device_arrays, callback=callback,
                                        out=out, priority=priority, qos=qos)

            # batched submission: a submit_error fails the WHOLE group
            # before any slot is taken (uniform with tx/rx_async), while
            # per-descriptor ``_one`` faults fail only the affected ticket
            # — overriding ``_one`` already forces the engine off the
            # fused fast path, so injection seams stay per-descriptor.
            def tx_many(self, host_arrays, priority=None, *, qos=None):
                self._maybe_submit_error("tx")
                return super().tx_many(host_arrays, priority=priority,
                                       qos=qos)

            def rx_many(self, device_arrays, out=None, priority=None, *,
                        qos=None):
                self._maybe_submit_error("rx")
                return super().rx_many(device_arrays, out=out,
                                       priority=priority, qos=qos)

            # scatter-gather rides _submit_many; overriding _one above
            # already forces its per-segment loop, so payload-stage faults
            # land on individual segment tickets (mid-segment isolation).
            def tx_sg(self, segments, priority=None, *, qos=None):
                self._maybe_submit_error("tx")
                return super().tx_sg(segments, priority=priority, qos=qos)

            def rx_sg(self, segments, out=None, priority=None, *, qos=None):
                self._maybe_submit_error("rx")
                return super().rx_sg(segments, out=out, priority=priority,
                                     qos=qos)

        def factory(policy, **kw):
            eng = _FaultEngine(policy, **kw)
            with injector._lock:
                eng._fault_channel = injector._n_engines
                injector._n_engines += 1
            return eng

        return factory


@dataclass(frozen=True)
class RecoveryConfig:
    """Tuning for the channel layer's self-healing (consumed by
    :class:`~repro_torch.core.channels.ChannelGroup`; injector-agnostic).

    ``stripe_timeout_s``: bound on every stripe ticket wait — a lost
    completion becomes a retryable ``TransferTimeoutError`` after this
    long (None keeps waits unbounded, the pre-fault-layer behaviour).
    ``max_retries``: resubmissions of one failed stripe on sibling
    channels before the error surfaces. ``quarantine_after``: consecutive
    faults that pull a channel from the stripe rotation.
    ``drift_quarantine_ratio``: a channel whose median seconds/byte over
    recent descriptors exceeds the healthy-group median by this factor is
    quarantined (None disables drift quarantine);
    ``health_min_samples`` fresh per-channel descriptor samples must exist
    before the drift verdict is trusted. Quarantined channels are probed
    with a ``probe_bytes`` transfer at most every ``probe_interval_s``
    seconds and rejoin the rotation on success."""

    stripe_timeout_s: float | None = None
    max_retries: int = 2
    quarantine_after: int = 3
    drift_quarantine_ratio: float | None = 4.0
    health_min_samples: int = 8
    probe_bytes: int = 64 << 10
    probe_interval_s: float = 1.0

    def __post_init__(self) -> None:
        if self.stripe_timeout_s is not None and self.stripe_timeout_s <= 0:
            raise ValueError("stripe_timeout_s must be positive or None")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.quarantine_after < 1:
            raise ValueError("quarantine_after must be >= 1")
        if (self.drift_quarantine_ratio is not None
                and self.drift_quarantine_ratio <= 1.0):
            raise ValueError("drift_quarantine_ratio must be > 1 or None")
