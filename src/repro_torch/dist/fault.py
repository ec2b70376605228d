"""Fault policy and per-run fault-event accounting.

Two consumers share this module:

- the training loop (``train/loop.py``, ``Trainer.run``) — every step's
  wall time and finite-ness verdict flow through
  :meth:`FaultState.record_step`, which flags stragglers (z-score over a
  rolling window, via :class:`repro_torch.utils.timing.StepClock`) and
  counts steps the optimizer skipped because of non-finite gradients.
  Restart counting is incremented by the loop when it resumes from a
  checkpoint.
- the transfer stack's self-healing layer (``repro_torch.core.faults``
  and the channel-group retry/quarantine machinery) —
  :class:`TransferFaultState` is its ledger: one thread-safe counter
  block per engine/group recording descriptor timeouts, stripe retries,
  checksum failures and channel quarantine transitions, so serving
  engines can expose deadline-miss and retry rates without reaching into
  channel internals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.analysis.validated import make_lock
from repro_torch.utils.timing import StepClock


@dataclass(frozen=True)
class FaultPolicy:
    """Knobs for loop-level fault tolerance. Defaults match the trainer."""

    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    straggler_window: int = 50
    straggler_zscore: float = 4.0
    skip_nonfinite: bool = True
    max_restarts: int = 16


@dataclass
class FaultState:
    """Mutable per-run fault counters (one per Trainer)."""

    policy: FaultPolicy = field(default_factory=FaultPolicy)
    restarts: int = 0
    stragglers_detected: int = 0
    steps_skipped_nonfinite: int = 0
    steps_recorded: int = 0
    _clock: StepClock | None = None

    def __post_init__(self) -> None:
        if self._clock is None:
            self._clock = StepClock(window=self.policy.straggler_window,
                                    zscore_threshold=self.policy.straggler_zscore)

    def record_step(self, dt_s: float, step_ok: float = 1.0) -> bool:
        """Record one step; returns True if the step was anomalous
        (straggler wall time and/or skipped as non-finite)."""
        self.steps_recorded += 1
        straggler = self._clock.record(dt_s)
        if straggler:
            self.stragglers_detected += 1
        skipped = step_ok < 0.5
        if skipped:
            self.steps_skipped_nonfinite += 1
        return straggler or skipped

    def summary(self) -> dict[str, int]:
        return {
            "steps": self.steps_recorded,
            "restarts": self.restarts,
            "stragglers": self.stragglers_detected,
            "skipped_nonfinite": self.steps_skipped_nonfinite,
        }


class TransferFaultState:
    """Thread-safe fault ledger for one transfer surface (engine / channel
    group / adaptive facade — an adaptive facade hands ONE instance to every
    plan generation, so counters survive safe-point swaps).

    Counter semantics: ``faults`` is every observed fault event (injected
    or organic — timeouts and checksum failures are also counted in their
    own columns); ``retries``/``retry_successes`` track the channel layer's
    resubmit-on-sibling path; ``quarantines``/``unquarantines`` count
    rotation transitions. ``faults_by_channel`` attributes events to the
    channel index that raised them; ``faults_by_tenant`` attributes them
    to the QosSpec tenant whose transfer hit the fault (fault/retry/
    quarantine columns per tenant), so a misbehaving tenant's retries are
    billable instead of vanishing into the per-class aggregate."""

    def __init__(self) -> None:
        self._lock = make_lock("TransferFaultState._lock")
        self.faults = 0  # guarded-by: _lock
        self.timeouts = 0  # guarded-by: _lock
        self.checksum_failures = 0  # guarded-by: _lock
        self.retries = 0  # guarded-by: _lock
        self.retry_successes = 0  # guarded-by: _lock
        self.quarantines = 0  # guarded-by: _lock
        self.unquarantines = 0  # guarded-by: _lock
        self.faults_by_channel: dict[int, int] = {}  # guarded-by: _lock
        self.faults_by_tenant: dict[str, dict[str, int]] = {}  # guarded-by: _lock

    def _tenant_row(self, tenant: str) -> dict[str, int]:  # requires-lock: _lock
        row = self.faults_by_tenant.get(tenant)
        if row is None:
            row = self.faults_by_tenant[tenant] = {
                "faults": 0, "timeouts": 0, "checksum_failures": 0,
                "retries": 0, "retry_successes": 0, "quarantines": 0}
        return row

    def record_fault(self, channel: int | None = None, *,
                     timeout: bool = False, checksum: bool = False,
                     tenant: str | None = None) -> None:
        with self._lock:
            self.faults += 1
            if timeout:
                self.timeouts += 1
            if checksum:
                self.checksum_failures += 1
            if channel is not None:
                self.faults_by_channel[channel] = (
                    self.faults_by_channel.get(channel, 0) + 1)
            if tenant is not None:
                row = self._tenant_row(tenant)
                row["faults"] += 1
                row["timeouts"] += int(timeout)
                row["checksum_failures"] += int(checksum)

    def record_retry(self, *, success: bool,
                     tenant: str | None = None) -> None:
        with self._lock:
            self.retries += 1
            if success:
                self.retry_successes += 1
            if tenant is not None:
                row = self._tenant_row(tenant)
                row["retries"] += 1
                row["retry_successes"] += int(success)

    def record_quarantine(self, channel: int, *, on: bool,
                          tenant: str | None = None) -> None:
        with self._lock:
            if on:
                self.quarantines += 1
            else:
                self.unquarantines += 1
            if tenant is not None and on:
                self._tenant_row(tenant)["quarantines"] += 1

    def summary(self) -> dict[str, int | dict]:
        with self._lock:
            return {
                "faults": self.faults,
                "timeouts": self.timeouts,
                "checksum_failures": self.checksum_failures,
                "retries": self.retries,
                "retry_successes": self.retry_successes,
                "quarantines": self.quarantines,
                "unquarantines": self.unquarantines,
                "faults_by_channel": dict(self.faults_by_channel),
                "faults_by_tenant": {t: dict(row) for t, row
                                     in self.faults_by_tenant.items()},
            }
