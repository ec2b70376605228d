"""Fault injection and self-healing channels on the CPU, held against the
reference: the same ``FaultPlan(seed)`` through the same modelled engines
(the ``engine_factory`` seam, as ``benchmarks/fault_recovery.py`` composes
it) injects the same events and draws the same retry, quarantine and
un-quarantine decisions and ``TransferFaultState`` counters in both
packages; the specs, the recovery tuning and ``dist/fault.py`` validate and
count alike."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.channels import ChannelGroup as JChannelGroup
from repro.core.faults import FaultInjector as JFaultInjector
from repro.core.faults import FaultPlan as JFaultPlan
from repro.core.faults import FaultSpec as JFaultSpec
from repro.core.faults import RecoveryConfig as JRecoveryConfig
from repro.core.transfer import TransferEngine as JTransferEngine
from repro.core.transfer import TransferFaultError as JTransferFaultError
from repro.core.transfer import TransferPolicy as JTransferPolicy
from repro.dist.fault import FaultState as JFaultState
from repro.dist.fault import TransferFaultState as JTransferFaultState
from repro.utils.timing import StepClock as JStepClock
from repro.utils.timing import bench as jbench
from repro_torch.core.channels import ChannelGroup
from repro_torch.core.faults import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedFault,
    RecoveryConfig,
)
from repro_torch.core.transfer import (
    TransferChecksumError,
    TransferEngine,
    TransferFaultError,
    TransferPolicy,
    _nbytes,
)
from repro_torch.dist import FaultPolicy, FaultState, TransferFaultState
from repro_torch.utils.timing import StepClock, bench

torch.set_num_threads(1)

PORT = dict(ChannelGroup=ChannelGroup, FaultInjector=FaultInjector,
            FaultPlan=FaultPlan, FaultSpec=FaultSpec,
            RecoveryConfig=RecoveryConfig, TransferEngine=TransferEngine,
            TransferPolicy=TransferPolicy, TransferFaultError=TransferFaultError,
            devices=lambda n: ["cpu"] * n)
REF = dict(ChannelGroup=JChannelGroup, FaultInjector=JFaultInjector,
           FaultPlan=JFaultPlan, FaultSpec=JFaultSpec,
           RecoveryConfig=JRecoveryConfig, TransferEngine=JTransferEngine,
           TransferPolicy=JTransferPolicy,
           TransferFaultError=JTransferFaultError, devices=lambda n: None)


def _modelled(base, t0_s: float, bw_Bps: float):
    """``base`` whose every descriptor pays ``t0 + n/BW`` of service time,
    one descriptor at a time (the fault_recovery benchmark's engine)."""

    class ModelledEngine(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._model_lock = threading.Lock()

        def _one_timed(self, payload, direction, out=None):
            with self._model_lock:
                return super()._one_timed(payload, direction, out)

        def _one(self, payload, direction, out=None):
            time.sleep(t0_s + _nbytes(payload) / bw_Bps)
            return super()._one(payload, direction, out)

    return ModelledEngine


def _group(pkg, specs, *, n=2, seed=0, checksum=False, t0_s=1e-4,
           block=1 << 16, min_stripe=1 << 14, **recovery):
    inj = pkg["FaultInjector"](pkg["FaultPlan"](
        seed=seed, specs=tuple(pkg["FaultSpec"](**s) for s in specs)))
    policy = pkg["TransferPolicy"].kernel_level_ring(4, block_bytes=block)
    if checksum:
        policy = dataclasses.replace(policy, checksum=True)
    g = pkg["ChannelGroup"](
        policy, n_channels=n, devices=pkg["devices"](n),
        min_stripe_bytes=min_stripe,
        engine_factory=inj.engine_factory(
            _modelled(pkg["TransferEngine"], t0_s, 1e9)),
        recovery=pkg["RecoveryConfig"](**recovery))
    return inj, g


def _flat(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(a).reshape(-1).view(np.uint8)
                           for a in arrays])


def _both(scenario):
    """Run ``scenario(pkg)`` through the port, then the reference; return
    both results."""
    return scenario(PORT), scenario(REF)


# ---- seeded schedules ------------------------------------------------------

def test_seeded_schedule_matches_reference_letter_for_letter():
    """A polling engine keeps every op on the caller's thread, so the
    ledger's order is reproducible: the per-channel Random((seed<<16) ^
    (ch+1)) streams give the reference's (channel, op, kind, direction,
    stage) sequence, and another seed another one."""

    def run(pkg, seed):
        inj = pkg["FaultInjector"](pkg["FaultPlan"](seed=seed, specs=(
            pkg["FaultSpec"](kind="delay", p=0.4, delay_s=0.0),
            pkg["FaultSpec"](kind="stall", p=0.3, stall_s=0.0),
            pkg["FaultSpec"](kind="delay", p=0.5, direction="rx",
                             after_ops=3, delay_s=0.0),
        )))
        kw = {"device": "cpu"} if pkg is PORT else {}
        eng = inj.engine_factory()(
            pkg["TransferPolicy"].user_level_polling(), **kw)
        for i in range(8):
            eng.rx(eng.tx(np.full(1 << 12, i, np.uint8)))
        eng.close()
        return list(inj.events)

    for seed in (11, 12):
        ours, ref = run(PORT, seed), run(REF, seed)
        assert ours == ref and ours
    assert run(PORT, 11) != run(PORT, 12)


def test_drop_and_corrupt_retry_on_sibling_like_reference():
    """A TX stripe dropped on channel 0 and an RX stripe corrupted there
    both retry on channel 1: exact bytes, the same events, the same
    ledger (checksum failures counted apart)."""

    def scenario(pkg):
        inj, g = _group(pkg, [
            dict(kind="drop", p=1.0, channel=0, direction="tx",
                 hold_s=0.0, max_injections=1),
            dict(kind="corrupt", p=1.0, channel=0, max_injections=1)],
            # one chunk a stripe: a failed stripe has no sibling chunk whose
            # start races the abort, so each channel's op count is fixed
            checksum=True, seed=1, block=1 << 17)
        x = np.arange(1 << 18, dtype=np.uint8)
        try:
            chunks = g.tx(x)
            back = g.rx(chunks)
            return (_flat(chunks), _flat(back), sorted(inj.events),
                    g.fault_state.summary())
        finally:
            g.close()

    (tx, rx, ev, s), (jtx, jrx, jev, js) = _both(scenario)
    x = np.arange(1 << 18, dtype=np.uint8)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(rx, x)
    np.testing.assert_array_equal(jrx, x)
    assert ev == jev and [e[2] for e in ev] == ["drop", "corrupt"]
    assert s == js
    assert s["faults"] == 2 and s["faults_by_channel"] == {0: 2}
    assert s["retries"] == s["retry_successes"] == 2
    assert s["checksum_failures"] == 1


def test_consecutive_faults_quarantine_then_probe_rejoins_like_reference():
    """Two drops on channel 0 in a row quarantine it; once the fault burns
    out a probe brings it back — the same transitions, step by step."""

    def scenario(pkg):
        inj, g = _group(pkg, [dict(kind="drop", p=1.0, channel=0,
                                   direction="tx", hold_s=0.0,
                                   max_injections=2)],
                        n=3, seed=4, min_stripe=1 << 12,
                        quarantine_after=2, probe_interval_s=0.0,
                        drift_quarantine_ratio=None)
        x = np.arange(1 << 16, dtype=np.uint8) % 253
        steps = []
        try:
            for _ in range(3):
                np.testing.assert_array_equal(_flat(g.tx(x)),
                                              x.view(np.uint8))
                steps.append(sorted(g.quarantined))
            steps.append(g.maybe_adapt())
            steps.append(sorted(g.quarantined))
            steps.append(sorted(g._active_indices()))
            return steps, sorted(inj.events), g.fault_state.summary()
        finally:
            g.close()

    (steps, ev, s), (jsteps, jev, js) = _both(scenario)
    assert steps == jsteps == [[], [0], [0], True, [], [0, 1, 2]]
    assert ev == jev and s == js
    assert (s["quarantines"], s["unquarantines"]) == (1, 1)


def test_stall_drift_quarantine_and_probe_gate_like_reference():
    """A stalled channel (every op 10x a healthy one) is pulled from the
    rotation by the drift check; a probe that completes while it is
    still stalled keeps it out; a probe at a healthy rate rejoins it."""

    def scenario(pkg):
        inj, g = _group(pkg, [], n=3, seed=6, t0_s=15e-3, block=1 << 16,
                        min_stripe=1 << 12, drift_quarantine_ratio=3.0,
                        health_min_samples=4, probe_interval_s=0.0,
                        probe_bytes=1 << 12)
        x = np.zeros(3 << 16, np.uint8)
        steps = []
        try:
            inj.stall(0, on=True, stall_s=0.15)
            for _ in range(4):
                g.tx(x)
            steps.append(g.check_channel_health())
            steps.append(sorted(g.quarantined))
            ops0 = dict(inj._ops).get(0, 0)
            g.tx(x)  # channel 0 takes no stripe now
            steps.append(inj._ops.get(0, 0) == ops0)
            steps.append(g.check_channel_health())  # completes, too slow
            steps.append(sorted(g.quarantined))
            inj.stall(0, on=False)
            steps.append(g.check_channel_health())  # healthy probe
            steps.append(sorted(g.quarantined))
            return steps, g.fault_state.summary()
        finally:
            g.close()

    (steps, s), (jsteps, js) = _both(scenario)
    assert steps == jsteps
    assert steps == [True, [0], True, False, [0], True, []]
    assert s == js and (s["quarantines"], s["unquarantines"]) == (1, 1)


def test_retry_exhaustion_and_structural_errors_like_reference():
    def scenario(pkg):
        inj, g = _group(pkg, [dict(kind="drop", p=1.0, direction="tx",
                                   hold_s=0.0)], seed=2, max_retries=1,
                        quarantine_after=10)
        try:
            with pytest.raises(pkg["TransferFaultError"]):
                g.tx(np.zeros(1 << 16, np.uint8))
            summary = g.fault_state.summary()
        finally:
            g.close()
        _, g = _group(pkg, [])
        try:
            with pytest.raises((ValueError, TypeError)):
                g.tx(object())  # not a payload: never retried
            assert g.fault_state.summary()["retries"] == 0
        finally:
            g.close()
        return summary

    s, js = _both(scenario)
    # both stripes fault, retry once on the sibling and fault again
    assert s == js and s["faults"] == 4 and s["retries"] == 2
    assert s["retry_successes"] == 0


def test_checksum_mismatch_never_corrupts_the_device_copy():
    inj = FaultInjector(FaultPlan(seed=8, specs=(
        FaultSpec(kind="corrupt", p=1.0, max_injections=1),)))
    eng = inj.engine_factory()(dataclasses.replace(
        TransferPolicy.kernel_level_ring(4, block_bytes=1 << 16),
        checksum=True), device="cpu")
    try:
        x = np.arange(1 << 16, dtype=np.uint8)
        chunks = eng.tx(x)
        with pytest.raises(TransferChecksumError):
            eng.rx(chunks)
        assert eng.summary()["checksum_failures"] == 1
        np.testing.assert_array_equal(_flat(eng.rx(chunks)), x)
        # the RX landing zone is what a corrupt flips, never the source
        out = np.empty_like(x)
        inj2 = FaultInjector(FaultPlan(seed=8, specs=(
            FaultSpec(kind="corrupt", p=1.0, max_injections=1),)))
        eng2 = inj2.engine_factory()(TransferPolicy.kernel_level(),
                                     device="cpu")
        eng2.rx([chunks[0]], out=[out])
        assert out[0] == x[0] ^ 0xFF and (out[1:] == x[1:]).all()
        np.testing.assert_array_equal(chunks[0].numpy(), x)
        eng2.close()
    finally:
        eng.close()


def test_drop_in_a_batch_fails_only_its_ticket():
    inj = FaultInjector(FaultPlan(seed=5, specs=(
        FaultSpec(kind="drop", p=1.0, direction="tx", after_ops=2,
                  hold_s=0.0, max_injections=1),)))
    eng = inj.engine_factory()(TransferPolicy.kernel_level_ring(4),
                               device="cpu")
    try:
        arrays = [np.full(1 << 10, i, np.uint8) for i in range(5)]
        tickets = eng.tx_many(arrays)
        with pytest.raises(InjectedFault):
            tickets[1].wait(5.0)
        for i in (0, 2, 3, 4):
            np.testing.assert_array_equal(tickets[i].wait(5.0).numpy(),
                                          arrays[i])
        assert eng.tx_bytes_total == 4 * (1 << 10)
        assert eng._inflight == 0 and not any(eng._slot_held)
    finally:
        eng.close()


# ---- validation ------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(stripe_timeout_s=0.0),
                                dict(max_retries=-1),
                                dict(quarantine_after=0),
                                dict(drift_quarantine_ratio=1.0)])
def test_recovery_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        RecoveryConfig(**kw)
    with pytest.raises(ValueError):
        JRecoveryConfig(**kw)


@pytest.mark.parametrize("kw", [dict(kind="gremlin"),
                                dict(kind="delay", p=1.5),
                                dict(kind="delay", direction="sideways"),
                                dict(kind="corrupt", direction="tx")])
def test_fault_spec_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        FaultSpec(**kw)
    with pytest.raises(ValueError):
        JFaultSpec(**kw)


def test_corrupt_pins_itself_to_rx():
    assert FaultSpec(kind="corrupt").direction == "rx"
    assert FaultPlan(specs=[FaultSpec(kind="delay")]).specs == (
        FaultSpec(kind="delay"),)


# ---- dist/fault.py and utils/timing.py -------------------------------------

def test_fault_state_and_step_clock_match_reference():
    rng = np.random.default_rng(0)
    times = list(0.1 + rng.random(40) * 1e-3) + [1.0, 0.1, 2.0]
    oks = [1.0] * 38 + [0.0, 1.0, 0.0, 1.0, 1.0]
    st, jst = FaultState(), JFaultState()
    clock, jclock = StepClock(window=20), JStepClock(window=20)
    for t, ok in zip(times, oks):
        assert st.record_step(t, step_ok=ok) == jst.record_step(t,
                                                                step_ok=ok)
        assert clock.record(t) == jclock.record(t)
    assert st.summary() == jst.summary()
    assert st.stragglers_detected >= 1 and st.steps_skipped_nonfinite == 2
    assert FaultPolicy().checkpoint_every > 0


def test_transfer_fault_state_matches_reference():
    fs, jfs = TransferFaultState(), JTransferFaultState()
    for f in (fs, jfs):
        f.record_fault(0, timeout=True, tenant="a")
        f.record_fault(1, checksum=True)
        f.record_fault(None, tenant="b")
        f.record_retry(success=True, tenant="a")
        f.record_retry(success=False)
        f.record_quarantine(1, on=True, tenant="b")
        f.record_quarantine(1, on=False)
    assert fs.summary() == jfs.summary()
    assert fs.summary()["faults_by_tenant"]["a"]["timeouts"] == 1


def test_bench_timer_matches_reference():
    calls = []
    t, jt = (b(lambda: calls.append(1), warmup=1, iters=4)
             for b in (bench, jbench))
    assert len(t.samples_s) == len(jt.samples_s) == 4 and len(calls) == 10
    assert t.min_s <= t.median_s and t.mean_s > 0
