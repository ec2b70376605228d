"""Online transfer adaptation on the CPU, held against the reference: the
rolling fit and the polling/interrupt crossover on the same samples, the
controller's proposals on the same drift sequence, warm-start state files
that either package writes and the other loads, and safe-point plan swaps
under concurrent submitters."""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from repro.core.adaptive import OnlineTransferController as JController
from repro.core.adaptive import RollingFit as JRollingFit
from repro.core.adaptive import AdaptiveChannelGroup as JAdaptiveGroup
from repro.core.adaptive import AdaptiveConfig as JAdaptiveConfig
from repro.core.adaptive import choose_management as jchoose_management
from repro.core.cost_model import TransferCostModel as JTransferCostModel
from repro.core.streaming import HostStreamingExecutor as JExecutor
from repro_torch.core.adaptive import (
    AdaptiveChannelGroup,
    AdaptiveConfig,
    OnlineTransferController,
    RollingFit,
    choose_management,
)
from repro_torch.core.cost_model import TransferCostModel
from repro_torch.core.streaming import HostStreamingExecutor
from repro_torch.core.transfer import Management, reassemble_chunks
from repro_torch.dist import TransferFaultState

torch.set_num_threads(1)

SIZES = (8 << 10, 64 << 10, 512 << 10, 2 << 20)


def _samples(model, sizes=SIZES, repeats=8, jitter_seed=None):
    rng = None if jitter_seed is None else np.random.default_rng(jitter_seed)
    out = []
    for _ in range(repeats):
        for n in sizes:
            t = model.t0_s + n / model.bw_Bps
            if rng is not None:
                t *= float(rng.uniform(0.9, 1.12))
            out.append((n, t))
    return out


def _controllers(**cfg_kw):
    cfg_kw.setdefault("min_samples", 8)
    cfg_kw.setdefault("refit_every", 1)
    ctl = OnlineTransferController(
        8 << 20, model=TransferCostModel(100e-6, 2e9),
        cfg=AdaptiveConfig(**cfg_kw))
    jctl = JController(
        8 << 20, model=JTransferCostModel(100e-6, 2e9),
        cfg=JAdaptiveConfig(**cfg_kw))
    return ctl, jctl


def _state(ctl) -> tuple:
    return (ctl.plan.row(), ctl.plan.policy.tag, ctl.refits, ctl.replans,
            ctl.suppressed, ctl.needs_probe)


# ---- RollingFit and the crossover ------------------------------------------

@pytest.mark.parametrize("halflife,ttl", [(64, 5.0), (8, 5.0), (32, 60.0)])
def test_rolling_fit_matches_reference(halflife, ttl):
    fit = RollingFit(window=128, ewma_halflife=halflife, ttl_s=ttl)
    jfit = JRollingFit(window=128, ewma_halflife=halflife, ttl_s=ttl)
    trace = (_samples(TransferCostModel(50e-6, 4e9), repeats=6)
             + _samples(TransferCostModel(1e-3, 1e9), repeats=10,
                        jitter_seed=0))
    for n, t in trace:
        fit.add(n, t)
        jfit.add(n, t)
    m, jm = fit.fit(4), jfit.fit(4)
    assert m.t0_s == pytest.approx(jm.t0_s, rel=1e-9)
    assert m.bw_Bps == pytest.approx(jm.bw_Bps, rel=1e-9)
    assert fit.size_spread == jfit.size_spread and len(fit) == len(jfit)
    # a single size cannot separate t0 from BW: neither fits
    one, jone = RollingFit(), JRollingFit()
    for _ in range(30):
        one.add(1 << 20, 1e-3)
        jone.add(1 << 20, 1e-3)
    assert one.fit(4) is None and jone.fit(4) is None


def test_rolling_fit_state_crosses_packages():
    fit = RollingFit(window=64)
    for n, t in _samples(TransferCostModel(120e-6, 2e9), repeats=4):
        fit.add(n, t)
    state = json.loads(json.dumps(fit.to_state()))
    clone, jclone = (RollingFit.from_state(state, window=64),
                     JRollingFit.from_state(state, window=64))
    assert len(clone) == len(jclone) == len(fit)
    assert clone.fit(4).t0_s == pytest.approx(jclone.fit(4).t0_s, rel=1e-9)


@pytest.mark.parametrize("payload_scale", [0.3, 0.9, 1.1, 4.0])
@pytest.mark.parametrize("extra,batch", [(0.0, 1.0), (500e-6, 1.0),
                                         (500e-6, 32.0)])
def test_choose_management_matches_reference(payload_scale, extra, batch):
    poll, intr = (2e-6, 2e9), (30e-6, 3e9)
    n_star = TransferCostModel.crossover_bytes(TransferCostModel(*poll),
                                               TransferCostModel(*intr))
    payload = int(n_star * payload_scale)
    ours = choose_management(
        {"polling": TransferCostModel(*poll),
         "interrupt": TransferCostModel(*intr)}, payload,
        interrupt_extra_t0_s=extra, batch=batch)
    ref = jchoose_management(
        {"polling": JTransferCostModel(*poll),
         "interrupt": JTransferCostModel(*intr)}, payload,
        interrupt_extra_t0_s=extra, batch=batch)
    assert ours.value == ref.value
    # one-sided data keeps the current mode
    assert choose_management({"interrupt": TransferCostModel(*intr)},
                             64) is Management.INTERRUPT


# ---- the controller on the same drift sequence ------------------------------

def test_controller_proposals_match_reference_on_a_drift_sequence():
    """Noise within the hysteresis, then a 5x t0 drift, then RX-only
    drift, then a polling-friendly small-payload mix: after every propose
    both controllers hold the same plan and the same counters."""
    ctl, jctl = _controllers(hysteresis=1.5)
    phases = [
        ("tx", "interrupt", _samples(TransferCostModel(115e-6, 1.7e9),
                                     jitter_seed=1), 5),
        ("tx", "interrupt", _samples(TransferCostModel(500e-6, 2e9),
                                     repeats=20), 1),
        ("rx", "interrupt", _samples(TransferCostModel(120e-6, 2e9)), 2),
        ("rx", "interrupt", _samples(TransferCostModel(1.2e-3, 1e9),
                                     repeats=20), 3),
        ("tx", "polling", _samples(TransferCostModel(2e-6, 2e9),
                                   sizes=(1 << 10, 4 << 10, 16 << 10,
                                          64 << 10)), 2),
    ]
    for direction, mode, samples, proposes in phases:
        for n, t in samples:
            ctl.add_chunk_sample(direction, mode, n, t)
            jctl.add_chunk_sample(direction, mode, n, t)
        for _ in range(proposes):
            ours, ref = ctl.propose(), jctl.propose()
            assert (ours is None) == (ref is None)
            if ours is not None:
                assert ours.row() == ref.row()
            assert _state(ctl) == _state(jctl)
    assert ctl.replans >= 2 and ctl.suppressed >= 1
    # the small-payload mix below the crossover flips both to polling
    ctl._payloads.clear()
    jctl._payloads.clear()
    ctl._payloads.append(16 << 10)
    jctl._payloads.append(16 << 10)
    for n in (1 << 10, 4 << 10, 16 << 10, 64 << 10):
        for c in (ctl, jctl):
            c.add_chunk_sample("tx", "interrupt", n, 500e-6 + n / 2.5e9)
    ours, ref = ctl.propose(force=True), jctl.propose(force=True)
    assert ours.row() == ref.row()
    assert ours.policy.management is Management.POLLING
    # quarantine replans bound the plan alike
    assert (ctl.replan_channels(1) is None) == (jctl.replan_channels(1)
                                                is None)


def test_dispatch_latency_and_batch_ewma_match_reference():
    ctl, jctl = _controllers(hysteresis=1.1)
    for c, M in ((ctl, TransferCostModel), (jctl, JTransferCostModel)):
        poll, intr = M(2e-6, 2e9), M(30e-6, 3e9)
        for _ in range(8):
            for n in (1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10):
                c.add_chunk_sample("tx", "polling", n, poll.time_unique(n))
                c.add_chunk_sample("tx", "interrupt", n,
                                   intr.time_unique(n))
        c._payloads.clear()
        c._payloads.append(int(M.crossover_bytes(poll, intr) * 2))
    assert ctl.propose(force=True).row() == jctl.propose(force=True).row()
    for c in (ctl, jctl):
        for _ in range(32):
            c.note_dispatch_latency(2e-3)
    ours, ref = ctl.propose(force=True), jctl.propose(force=True)
    assert ours.row() == ref.row()
    assert ours.policy.management is Management.POLLING
    for c in (ctl, jctl):
        for _ in range(64):
            c.note_submit_batch(32)
    assert ctl._batch_ewma == pytest.approx(jctl._batch_ewma, rel=1e-12)


# ---- warm-start state files -------------------------------------------------

def _fitted(ctl):
    for n, t in _samples(TransferCostModel(300e-6, 1.5e9), repeats=10):
        ctl.add_chunk_sample("tx", "interrupt", n, t)
    ctl.add_chunk_sample("rx", "interrupt", 1 << 20, 1e-3)
    ctl.propose(force=True)
    return ctl


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_state_file_crosses_packages(tmp_path, writer):
    """A state that one package saves, the other loads: the same first
    plan, drift references and seeded fit windows."""
    path = tmp_path / "transfer_state.json"
    ctl, jctl = _controllers()
    src = _fitted(jctl if writer == "reference" else ctl)
    src.save(path)
    for cls in (OnlineTransferController, JController):
        loaded = cls.load(path)
        assert loaded.plan.row() == src.plan.row()
        assert loaded.plan.policy.tag == src.plan.policy.tag
        assert loaded._tx_ref.t0_s == src._tx_ref.t0_s
        m = loaded._fit_for("tx", "interrupt").fit(4)
        m_src = src._fit_for("tx", "interrupt").fit(4)
        assert m.t0_s == pytest.approx(m_src.t0_s, rel=1e-6)


def test_adaptive_group_warm_starts_from_a_reference_state(tmp_path):
    path = tmp_path / "state.json"
    jg = JAdaptiveGroup(8 << 20, model=JTransferCostModel(100e-6, 2e9),
                        state_path=path)
    jplan = jg.controller.plan
    jg.close()
    g = AdaptiveChannelGroup(8 << 20, state_path=path, devices=["cpu"])
    try:
        assert g.warm_started and g.device == torch.device("cpu")
        assert g.plan.row() == jplan.row()
        x = np.arange(1 << 16, dtype=np.float32)
        np.testing.assert_array_equal(reassemble_chunks(g.tx(x)).numpy(), x)
    finally:
        g.close()
    # and the port's save on close warm-starts the reference
    jg2 = JAdaptiveGroup(8 << 20, state_path=path)
    try:
        assert jg2.warm_started and jg2.plan.row() == jplan.row()
    finally:
        jg2.close()


# ---- the facade ---------------------------------------------------------------

def _group(**cfg_kw):
    cfg_kw.setdefault("min_samples", 8)
    cfg_kw.setdefault("refit_every", 1)
    return AdaptiveChannelGroup(
        8 << 20, model=TransferCostModel(100e-6, 2e9),
        cfg=AdaptiveConfig(**cfg_kw), devices=["cpu"])


def test_adaptive_group_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveChannelGroup(8 << 20, model=TransferCostModel(1e-4, 2e9))
    with pytest.raises(ValueError, match="share one device"):
        AdaptiveChannelGroup(8 << 20, model=TransferCostModel(1e-4, 2e9),
                             devices=["cpu", "meta"])


def test_adaptive_group_shares_one_fault_ledger_and_device():
    fs = TransferFaultState()
    g = AdaptiveChannelGroup(1 << 20, model=TransferCostModel(20e-6, 4e9),
                             fault_state=fs, devices=["cpu"])
    try:
        assert g.fault_state is fs and g._group.fault_state is fs
        assert all(e.device == g.device for e in g.engines)
        assert g.fault_summary() == {"faults": fs.summary(),
                                     "quarantined": []}
    finally:
        g.close()


def test_forced_swap_keeps_layouts_and_matches_reference():
    """The same forced drift swaps a generation in both packages, to the
    same plan; the port's new generation keeps the layout cache and still
    round-trips exactly."""
    g = _group()
    jg = JAdaptiveGroup(8 << 20, model=JTransferCostModel(100e-6, 2e9),
                        cfg=JAdaptiveConfig(min_samples=8, refit_every=1))
    try:
        layouts = g.layouts
        for c in (g.controller, jg.controller):
            for n, t in _samples(TransferCostModel(4e-3, 1e9), repeats=16):
                c.add_chunk_sample("tx", "interrupt", n, t)
        assert g.maybe_adapt(force=True) and jg.maybe_adapt(force=True)
        assert g.generation == jg.generation == 1
        assert g.plan.row() == jg.plan.row()
        assert g.layouts is layouts
        x = np.random.default_rng(0).standard_normal(1 << 18).astype(
            np.float32)
        back = g.rx(g.tx(x))
        np.testing.assert_array_equal(
            np.concatenate([np.asarray(b).reshape(-1) for b in back]), x)
    finally:
        g.close()
        jg.close()


def test_safe_point_swap_under_concurrent_submitters():
    """Six threads round-trip through the facade while the main thread
    forces plan swaps: a swap waits for the ring to drain, every byte
    lands exactly, and no ring slot is ever held twice."""
    g = _group()
    n_threads, iters, n_elems = 6, 5, 16 * 1024
    errors: list = []
    go = threading.Event()

    def hammer(seed):
        try:
            go.wait(10)
            x = np.full(n_elems, float(seed), np.float32)
            for _ in range(iters):
                out = np.empty_like(x)
                g.rx(g.tx(x), out=out)
                np.testing.assert_array_equal(out, x)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=hammer, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        go.set()
        drift = TransferCostModel(4e-3, 1e9)
        while any(t.is_alive() for t in threads):
            for n, t in _samples(drift, repeats=2):
                g.controller.add_chunk_sample("tx", "interrupt", n, t)
            g.maybe_adapt(force=True)
            drift = TransferCostModel(drift.t0_s * 3, drift.bw_Bps)
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        g.close()
    assert not errors, errors
    assert g.swaps >= 1
    for e in g.all_engines:
        assert e.slot_collisions == 0 and e.inflight_hwm <= e.policy.depth
    per_tx = n_elems * 4
    assert sum(s.nbytes for s in g.stats if s.direction == "tx"
               and s.nbytes == per_tx) == n_threads * iters * per_tx


def test_adaptive_group_runs_streaming_executor_like_reference():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((32, 32)).astype(np.float32) for _ in range(4)]
    x = rng.standard_normal((2, 32)).astype(np.float32)
    g = _group()
    jg = JAdaptiveGroup(8 << 20, model=JTransferCostModel(100e-6, 2e9),
                        cfg=JAdaptiveConfig(min_samples=8, refit_every=1))
    jfn = jax.jit(lambda params, h: jnp.tanh(h @ params[0]))
    try:
        out, timing = HostStreamingExecutor(g).run(
            [(f"l{i}", [w], lambda params, h: torch.tanh(h @ params[0]))
             for i, w in enumerate(ws)], x)
        ref, _ = JExecutor(jg).run(
            [(f"l{i}", [w], jfn) for i, w in enumerate(ws)], x)
    finally:
        g.close()
        jg.close()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert len(timing.layers) == 4
