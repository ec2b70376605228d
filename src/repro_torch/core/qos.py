"""The unified QoS submit context + serving-side admission control.

One object — :class:`QosSpec` — carries every quality-of-service knob a
transfer submission can set, through every layer of the stack::

    engine.tx(arr, qos=QosSpec(priority=PriorityClass.TOKEN,
                               tenant="user-42", weight=2.0))

Before this module the knobs were scattered: ``priority=`` on the eight
engine submit methods, ``class_caps=`` / ``rx_timeout_s=`` / ``rx_group=``
on :class:`~repro.serve.engine.ServeConfig` and
:class:`~repro.serve.continuous.ContinuousBatchingEngine`. Those kwargs
still work for one release of compat, but they are deprecation shims:
each builds a ``QosSpec`` internally and emits a ``DeprecationWarning``
(see :func:`resolve_submit_qos`). The arbitration they produce is
identical — the shim IS the new path.

Tenancy (PR 10) rides the same object: ``tenant`` names a flow inside the
descriptor's priority class, ``weight`` its byte-weighted fair share
among the class's tenants, ``cap_bytes_per_s``/``burst_s`` its private
token bucket under the class cap (the cap *tree* — see
:mod:`repro_torch.core.runtime`). ``deadline_s`` overrides the class EDF
deadline per submission; ``timeout_s`` bounds serving-side ticket waits;
``rx_group`` sets the serving token-RX batching factor.

Admission control
-----------------
The serving layer must shed load *before* the accelerator queue backs up
(NEURAghe's host-side co-scheduling argument): :class:`AdmissionController`
turns two runtime signals — a tenant's queued-descriptor depth and the
class's recent deadline-miss rate — into an explicit
:class:`AdmissionDecision` (``accept`` / ``queue`` / ``shed`` plus a
retry-after hint). A shed submitter gets the decision (or
:class:`AdmissionError` on the synchronous paths), never a hang and never
a silently collapsed p99. Thresholds live in :class:`AdmissionPolicy`.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Any, Mapping

from repro_torch.analysis.validated import make_lock
from repro_torch.core.runtime import DEFAULT_TENANT, PriorityClass

__all__ = [
    "DEFAULT_TENANT",
    "QosSpec",
    "AdmissionPolicy",
    "AdmissionDecision",
    "AdmissionController",
    "AdmissionError",
    "resolve_submit_qos",
    "warn_deprecated_kwarg",
]

# DEFAULT_TENANT (re-exported from the runtime): the flow every untagged
# submission lands in. One shared flow means untagged traffic arbitrates
# exactly like the pre-tenancy runtime did — single-tenant processes see
# byte-identical scheduling.


@dataclass(frozen=True)
class QosSpec:
    """The submit context: class, tenant, share, caps, deadlines.

    Every field defaults to ``None`` ("unset"), so specs merge: an engine
    holds a base spec, a per-call spec overrides only the fields it sets
    (:meth:`merged`). Resolution order is per-call > engine default >
    runtime class defaults.

    ``priority``
        Arbitration class (:class:`~repro_torch.core.runtime.PriorityClass`).
    ``tenant``
        Flow id inside the class; unset maps to :data:`DEFAULT_TENANT`.
    ``weight``
        Byte-weighted fair share among the class's tenants (tier-2 WFQ).
    ``cap_bytes_per_s`` / ``burst_s``
        Per-tenant token-bucket ceiling; bounded above by the class cap
        (both buckets must clear for a dispatch — the cap tree).
    ``deadline_s``
        Per-submission EDF deadline override (else the class default).
    ``timeout_s``
        Serving-side ticket-wait bound (was ``rx_timeout_s``).
    ``rx_group``
        Serving token-RX batching factor (was ``ServeConfig.rx_group``).
    ``class_caps``
        Class-name -> bytes/s ceilings applied at engine construction
        (was ``ServeConfig.class_caps``).
    """

    priority: PriorityClass | None = None
    tenant: str | None = None
    weight: float | None = None
    cap_bytes_per_s: float | None = None
    burst_s: float | None = None
    deadline_s: float | None = None
    timeout_s: float | None = None
    rx_group: int | None = None
    class_caps: Mapping[str, float] | None = None

    def merged(self, override: "QosSpec | None") -> "QosSpec":
        """This spec with ``override``'s SET fields taking precedence."""
        if override is None:
            return self
        kw = {f: v for f, v in (
            ("priority", override.priority),
            ("tenant", override.tenant),
            ("weight", override.weight),
            ("cap_bytes_per_s", override.cap_bytes_per_s),
            ("burst_s", override.burst_s),
            ("deadline_s", override.deadline_s),
            ("timeout_s", override.timeout_s),
            ("rx_group", override.rx_group),
            ("class_caps", override.class_caps),
        ) if v is not None}
        return replace(self, **kw) if kw else self

    def with_(self, **kw: Any) -> "QosSpec":
        """A copy with the given fields replaced."""
        return replace(self, **kw)

    @property
    def effective_tenant(self) -> str:
        return self.tenant if self.tenant is not None else DEFAULT_TENANT


def warn_deprecated_kwarg(old: str, new: str, *, stacklevel: int = 3) -> None:
    """One canonical deprecation message shape for every legacy QoS kwarg."""
    warnings.warn(
        f"{old} is deprecated; pass {new} instead (the legacy kwarg builds "
        f"the same QosSpec internally and will be removed next release)",
        DeprecationWarning, stacklevel=stacklevel)


def resolve_submit_qos(where: str, qos: "QosSpec | PriorityClass | None",
                       priority: PriorityClass | None) -> "QosSpec | None":
    """Normalise one submit call's ``(qos=, priority=)`` pair to a QosSpec.

    The deprecation shim behind every engine submit method: a legacy
    ``priority=`` kwarg (or a bare :class:`PriorityClass` passed where
    ``qos`` now sits positionally) folds into a ``QosSpec`` and warns.
    Returns ``None`` when neither was given (caller applies its default)."""
    if isinstance(qos, PriorityClass):  # old positional priority call shape
        if priority is not None:
            raise TypeError(
                f"{where}: got both a positional PriorityClass and "
                f"priority=; pass one qos=QosSpec(...) instead")
        qos, priority = None, qos
    if priority is not None:
        warn_deprecated_kwarg(
            f"{where}(priority=...)",
            f"{where}(qos=QosSpec(priority=...))", stacklevel=4)
        if qos is None:
            return QosSpec(priority=priority)
        if qos.priority is not None and qos.priority is not priority:
            raise ValueError(
                f"{where}: qos.priority={qos.priority} conflicts with "
                f"deprecated priority={priority}")
        return qos.with_(priority=priority)
    return qos


# ---------------------------------------------------------------------------
# Admission control (the serving-side backpressure valve)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AdmissionPolicy:
    """Thresholds the serving layer sheds on. Defaults are deliberately
    generous — admission exists to stop a *flooding* tenant, not to shave
    a busy one; a single-tenant process never trips them.

    ``queue_depth``: a tenant with this many queued-but-undispatched
    descriptors gets ``queue`` decisions (admitted, but told to back
    off). ``shed_depth``: above this the tenant is shed outright.
    ``shed_miss_rate``: when the class's recent deadline-miss fraction
    (over ``miss_window_s``) crosses this, NEW tenants are shed too —
    the runtime as a whole is past its deadline budget and queueing more
    only moves the collapse downstream. ``retry_after_s``: base backoff
    hint; the decision scales it with queue pressure."""

    queue_depth: int = 64
    shed_depth: int = 256
    shed_miss_rate: float = 0.5
    miss_window_s: float = 5.0
    retry_after_s: float = 0.05


@dataclass(frozen=True)
class AdmissionDecision:
    """The explicit backpressure signal: what happened to one submission
    attempt and when to retry. ``action`` is ``accept`` / ``queue`` /
    ``shed``; only ``shed`` means the request was NOT enqueued."""

    action: str
    tenant: str
    reason: str = ""
    retry_after_s: float | None = None
    queue_depth: int = 0
    miss_rate: float = 0.0

    @property
    def admitted(self) -> bool:
        return self.action != "shed"


class AdmissionError(RuntimeError):
    """Raised by synchronous serving paths when admission sheds the call
    (the async path returns the :class:`AdmissionDecision` instead)."""

    def __init__(self, decision: AdmissionDecision):
        hint = (f"; retry after {decision.retry_after_s:.3f}s"
                if decision.retry_after_s else "")
        super().__init__(
            f"admission shed tenant {decision.tenant!r}: "
            f"{decision.reason}{hint}")
        self.decision = decision


class AdmissionController:
    """Turns runtime pressure signals into accept/queue/shed decisions.

    Stateless with respect to the runtime (it only *reads*
    ``tenant_depth`` and ``deadline_miss_rate``); keeps its own decision
    ledger so ``fault_summary()``-style surfaces can report shed counts
    per tenant. With no runtime attached every decision is ``accept`` —
    a polling engine has no queue to protect."""

    def __init__(self, runtime: Any = None,
                 policy: AdmissionPolicy | None = None,
                 cls: PriorityClass = PriorityClass.TOKEN):
        self.policy = policy or AdmissionPolicy()
        self.cls = cls
        self._runtime = runtime
        self._lock = make_lock("AdmissionController._lock")
        self.accepts = 0                               # guarded-by: _lock
        self.queued = 0                                # guarded-by: _lock
        self.sheds = 0                                 # guarded-by: _lock
        self._by_tenant: dict[str, dict[str, int]] = {}  # guarded-by: _lock

    @property
    def runtime(self) -> Any:
        return self._runtime() if callable(self._runtime) else self._runtime

    def _note(self, tenant: str, action: str) -> None:
        with self._lock:
            row = self._by_tenant.setdefault(
                tenant, {"accept": 0, "queue": 0, "shed": 0})
            row[action] += 1
            if action == "accept":
                self.accepts += 1
            elif action == "queue":
                self.queued += 1
            else:
                self.sheds += 1

    def decide(self, tenant: str | None = None, *,
               cls: PriorityClass | None = None,
               extra_depth: int = 0) -> AdmissionDecision:
        """One admission decision for ``tenant`` at class ``cls``.

        ``extra_depth`` adds serving-layer backlog the runtime cannot see
        (e.g. a continuous-batching engine's host-side request queue) to
        the tenant's queued-descriptor depth before thresholding."""
        tenant = tenant if tenant is not None else DEFAULT_TENANT
        cls = cls or self.cls
        pol = self.policy
        rt = self.runtime
        depth = max(0, int(extra_depth))
        miss = 0.0
        if rt is not None:
            depth += rt.tenant_depth(cls, tenant)
            miss = rt.deadline_miss_rate(cls, ttl_s=pol.miss_window_s)
        if depth >= pol.shed_depth:
            d = AdmissionDecision(
                "shed", tenant,
                reason=(f"tenant queue depth {depth} >= shed threshold "
                        f"{pol.shed_depth}"),
                retry_after_s=pol.retry_after_s * max(
                    1.0, depth / max(pol.shed_depth, 1)),
                queue_depth=depth, miss_rate=miss)
        elif miss >= pol.shed_miss_rate and depth > 0:
            # a backlogged tenant on a runtime already missing deadlines:
            # more queueing cannot meet any deadline — shed with a hint
            # sized to the miss window (the time scale of the collapse).
            d = AdmissionDecision(
                "shed", tenant,
                reason=(f"deadline-miss rate {miss:.2f} >= "
                        f"{pol.shed_miss_rate} with tenant backlog {depth}"),
                retry_after_s=pol.miss_window_s / 2,
                queue_depth=depth, miss_rate=miss)
        elif depth >= pol.queue_depth:
            d = AdmissionDecision(
                "queue", tenant,
                reason=(f"tenant queue depth {depth} >= queue threshold "
                        f"{pol.queue_depth}"),
                retry_after_s=pol.retry_after_s,
                queue_depth=depth, miss_rate=miss)
        else:
            d = AdmissionDecision("accept", tenant, queue_depth=depth,
                                  miss_rate=miss)
        self._note(tenant, d.action)
        return d

    def summary(self) -> dict[str, Any]:
        with self._lock:
            return {
                "accepts": self.accepts,
                "queued": self.queued,
                "sheds": self.sheds,
                "by_tenant": {t: dict(row)
                              for t, row in self._by_tenant.items()
                              if row["shed"] or row["queue"]},
            }
