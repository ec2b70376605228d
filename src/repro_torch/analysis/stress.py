"""The reference's five concurrency stress hammers on the port's transfer
stack, and one hammer of the card's own.

The five keep the reference tests' threads, iterations, sizes, policies,
fault plan and assertions:

- :func:`four_classes`  ``tests/test_runtime.py::test_stress_four_classes_on_one_runtime``
- :func:`coalescing`    ``tests/test_runtime.py::test_stress_coalescing_four_class_hammer``
- :func:`chaos`         ``tests/test_faults.py::test_chaos_hammer_exact_byte_accounting_under_qos_load``
- :func:`tenants`       ``tests/test_tenancy.py::test_stress_multi_tenant_hammer_exact_byte_accounting``
- :func:`plan_swap`     ``tests/test_adaptive.py::test_stress_mid_run_plan_swap``

Each builds its own ``TransferRuntime(workers=2)`` (the plan-swap hammer
too, where the reference's rides the process-shared runtime), so under
:func:`validated_locks` every lock it takes is an order-validating one. A
failed check raises :class:`HammerError`. Each returns a
:class:`HammerResult`: the logical transfers and bytes it moved and the
counters that do not depend on how its threads interleave (bytes and
descriptors per engine, tenant and class), so that a run can be held
against another stack's run of the same traffic.

A hammer builds from a :class:`Stack`: the modules and the device the
engines copy to. :func:`port_stack` is the port's. A caller may hand in
any stack of the same surface with ``device=None`` (the CPU tests hand in
the reference's) and run it with ``concurrent=False``: every thread's
traffic then runs one body after another on the calling thread.

:func:`consumer_streams` needs a card: eight threads, each on a side
stream of its own, compute on a TX result, drop it before that kernel has
run, TX their next payload and RX the product; every product is held
bitwise against the host's arithmetic.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Any, Callable

import numpy as np

from . import validated

JOIN_S = 120.0  # a hammer thread that runs longer has hung
# the plan-swap hammer's cost-model samples (tests/test_adaptive.py:SIZES)
FEED_SIZES = (8 << 10, 64 << 10, 512 << 10, 2 << 20)
# cycles the consumer hammer's side stream spins before its kernel reads
# the TX result (~1 ms on an H100): the window in which the dropped block
# can be handed to another thread's next TX
CONSUMER_SPIN_CYCLES = 2_000_000
CONSUMER_THREADS = 8
# the consumer hammer's cases: (channels, iterations a thread, int32
# elements): an engine at 256 KiB, a group of two striped at 4 MiB
CONSUMER_CASES = ((1, 200, 64 * 1024), (2, 50, 1 << 20))


class HammerError(AssertionError):
    """A hammer's check failed (a thread's error, a lost byte, a ring
    invariant, a wrong result)."""


@dataclass(frozen=True)
class Stack:
    """The modules a hammer builds from, and the device its engines copy
    to (``None``: the stack's constructors take no device)."""

    runtime: ModuleType
    transfer: ModuleType
    qos: ModuleType
    faults: ModuleType
    channels: ModuleType
    adaptive: ModuleType
    cost_model: ModuleType
    device: Any = None

    def engine_kw(self) -> dict:
        return {} if self.device is None else {"device": self.device}

    def group_kw(self, n_channels: int) -> dict:
        return ({} if self.device is None
                else {"devices": [self.device] * n_channels})


def port_stack(device: Any = None) -> Stack:
    """The port's transfer stack on ``device`` (the current card unless the
    caller asks for another)."""
    from repro_torch.core import (adaptive, channels, cost_model, faults,
                                  qos, runtime, transfer)
    from repro_torch.device import default_device
    return Stack(runtime, transfer, qos, faults, channels, adaptive,
                 cost_model, default_device(device))


@dataclass
class HammerResult:
    name: str
    transfers: int
    bytes: int
    counters: dict
    seconds: float = 0.0
    extra: dict = field(default_factory=dict)

    def row(self) -> dict:
        return {"transfers": self.transfers, "bytes": self.bytes,
                "seconds": self.seconds, **self.extra}


@contextlib.contextmanager
def validated_locks():
    """Every lock made inside the block is an order-validating
    :class:`~repro_torch.analysis.validated.ValidatedLock`; locks made
    before it (the process-shared runtime's) stay plain. Yields the order
    graph, reset on entry; control returns to ``REPRO_VALIDATE_LOCKS`` on
    exit."""
    validated.enable(True)
    validated.order_graph.reset()
    try:
        yield validated.order_graph
    finally:
        validated.enable(None)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise HammerError(msg)


def _flat(host) -> np.ndarray:
    return np.concatenate([np.asarray(h).reshape(-1) for h in host])


def _equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    _check(got.shape == want.shape and np.array_equal(got, want),
           f"{what}: the round trip is not bitwise the payload")


def _run(bodies: list[Callable[[], None]], concurrent: bool) -> None:
    """Each body on a thread of its own (or, with ``concurrent=False``,
    one after another here); raises the first error any body raised."""
    errors: list[BaseException] = []

    def guard(body):
        try:
            body()
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    if concurrent:
        threads = [threading.Thread(target=guard, args=(b,)) for b in bodies]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        _check(not any(t.is_alive() for t in threads),
               f"a hammer thread ran past {JOIN_S} s")
    else:
        for b in bodies:
            guard(b)
    if errors:
        raise HammerError(f"{len(errors)} hammer thread(s) failed: "
                          f"{errors!r}") from errors[0]


def _ring_clean(eng, what: str) -> None:
    with eng._ring_lock:
        clean = eng._inflight == 0 and not any(eng._slot_held)
        collisions = eng.slot_collisions
    _check(clean, f"{what}: the ring is not clean")
    _check(collisions == 0, f"{what}: {collisions} slot collisions")


def _engine_counters(eng) -> dict:
    with eng._stats_lock:
        return {"tx_bytes": eng.tx_bytes_total, "rx_bytes": eng.rx_bytes_total,
                "tx_count": eng.tx_count, "rx_count": eng.rx_count}


def _class_counters(row: dict) -> dict:
    return {k: row[k] for k in ("submitted", "completed", "bytes_total")}


def _timed(fn):
    def run(stack: Stack, *, concurrent: bool = True) -> HammerResult:
        t0 = time.perf_counter()
        res = fn(stack, concurrent)
        res.seconds = time.perf_counter() - t0
        return res
    run.__name__ = fn.__name__
    run.__doc__ = fn.__doc__
    return run


@_timed
def four_classes(S: Stack, concurrent: bool) -> HammerResult:
    """SENSOR / TOKEN / LAYER / BULK engines on one runtime, 2 threads a
    class, 4 round trips of 32 KiB each, a background SENSOR task: exact
    bytes per engine, rings clean, every class completes all it submits."""
    PC = S.runtime.PriorityClass
    rt = S.runtime.TransferRuntime(workers=2)
    classes = [PC.SENSOR, PC.TOKEN, PC.LAYER, PC.BULK]
    engines = {cls: S.transfer.TransferEngine(
        S.transfer.TransferPolicy.kernel_level_ring(3, block_bytes=1 << 14),
        runtime=rt, priority=cls, **S.engine_kw()) for cls in classes}
    n_threads_per, iters, n_elems = 2, 4, 8 * 1024
    per_tx = n_elems * 4
    sensor_count = [0]
    unregister = rt.register_background(
        lambda: sensor_count.__setitem__(0, sensor_count[0] + 1))

    def hammer(cls, seed):
        eng = engines[cls]
        x = np.full(n_elems, float(seed), np.float32)
        for _ in range(iters):
            dev = eng.tx_async(x).wait()
            host = eng.rx_async(dev).wait()
            _equal(_flat(host), x, f"four_classes {cls.value}")

    try:
        _run([lambda c=cls, i=i: hammer(c, i)
              for i, cls in enumerate(classes) for _ in range(n_threads_per)],
             concurrent)
        unregister()
        expected = n_threads_per * iters * per_tx
        counters = {}
        for cls, eng in engines.items():
            c = _engine_counters(eng)
            _check(c["tx_bytes"] == expected and c["rx_bytes"] == expected,
                   f"four_classes {cls.value}: bytes {c}, want {expected}")
            _ring_clean(eng, f"four_classes {cls.value}")
            _check(eng.inflight_hwm <= eng.policy.depth,
                   f"four_classes {cls.value}: {eng.inflight_hwm} slots held")
            counters[cls.value] = c
            eng.close()
        s = rt.class_summary()
        for cls in classes:
            row = s[cls.value]
            _check(row["completed"] == row["submitted"] > 0,
                   f"four_classes {cls.value}: {row['completed']} of "
                   f"{row['submitted']} completed")
            counters[cls.value].update(_class_counters(row))
        _check(sensor_count[0] > 0, "four_classes: the SENSOR background "
               "task never ran")
        _check(rt.n_registered == 0, "four_classes: engines still registered")
    finally:
        rt.close()
    return HammerResult(
        "four_classes", sum(c["tx_count"] + c["rx_count"]
                            for c in counters.values()),
        2 * len(classes) * expected, counters,
        extra={"background_runs": sensor_count[0]})


@_timed
def coalescing(S: Stack, concurrent: bool) -> HammerResult:
    """Four classes WITH completion coalescing: 2 TOKEN threads batch 8 x 4
    KiB through ``tx_many`` / ``rx_many``, SENSOR / LAYER / BULK / BULK
    round-trip 8 KiB / 256 KiB / 1 MiB / 1 MiB. Exact bytes, every ticket
    resolved exactly once, BULK's window saves wakeups, and TOKEN's added
    delay stays within its 1 ms class deadline (the reference's bound)."""
    PC = S.runtime.PriorityClass
    rt = S.runtime.TransferRuntime(workers=2)
    classes = [PC.SENSOR, PC.TOKEN, PC.LAYER, PC.BULK]
    engines = {cls: S.transfer.TransferEngine(
        S.transfer.TransferPolicy.kernel_level_ring(4, block_bytes=1 << 15),
        runtime=rt, priority=cls, **S.engine_kw()) for cls in classes}
    iters = 6
    tok_elems, bulk_elems = 1024, 256 * 1024  # 4 KiB tokens, 1 MiB bulk

    def hammer_token():
        eng = engines[PC.TOKEN]
        x = [np.full(tok_elems, float(i), np.float32) for i in range(8)]
        for _ in range(iters):
            devs = [t.wait(30.0) for t in eng.tx_many(x)]
            outs = [np.empty(tok_elems, np.float32) for _ in x]
            for i, t in enumerate(eng.rx_many(devs, out=outs)):
                _check(t.wait(30.0) is outs[i],
                       "coalescing: rx_many did not land in its out buffer")
            for a, o in zip(x, outs):
                _equal(o, a, "coalescing token")

    def hammer_sync(cls, elems):
        eng = engines[cls]
        x = np.full(elems, 7.0, np.float32)
        for _ in range(iters):
            host = eng.rx_async(eng.tx_async(x).wait(30.0)).wait(30.0)
            _equal(_flat(host), x, f"coalescing {cls.value}")

    sync = [(PC.SENSOR, 2048), (PC.LAYER, 64 * 1024), (PC.BULK, bulk_elems),
            (PC.BULK, bulk_elems)]
    try:
        _run([hammer_token] * 2
             + [lambda c=c, n=n: hammer_sync(c, n) for c, n in sync],
             concurrent)
        counters = {cls.value: _engine_counters(eng)
                    for cls, eng in engines.items()}
        tok = 2 * iters * 8 * tok_elems * 4
        for key in ("tx_bytes", "rx_bytes"):
            _check(counters["token"][key] == tok,
                   f"coalescing token {key}: {counters['token'][key]}, "
                   f"want {tok}")
        _check(counters["bulk"]["tx_bytes"] == 2 * iters * bulk_elems * 4,
               f"coalescing bulk tx_bytes: {counters['bulk']['tx_bytes']}")
        s = rt.class_summary()
        for cls in classes:
            row = s[cls.value]
            _check(row["completed"] == row["submitted"] > 0,
                   f"coalescing {cls.value}: {row['completed']} of "
                   f"{row['submitted']} completed")
            _check(row["completion_wakeups"] + row["wakeups_saved"]
                   == row["completed"],
                   f"coalescing {cls.value}: wakeups "
                   f"{row['completion_wakeups']} + saved "
                   f"{row['wakeups_saved']} != {row['completed']}")
            counters[cls.value].update(_class_counters(row))
        saved = s["bulk"]["wakeups_saved"]
        tok_delay = s["token"]["coalesce_delay_p99_ms"]
        if concurrent:
            _check(saved > 0, "coalescing: BULK saved no wakeups")
            _check(tok_delay == tok_delay and tok_delay <= 1.0,
                   f"coalescing: TOKEN's coalescing delay p99 {tok_delay} ms")
        for cls, eng in engines.items():
            _ring_clean(eng, f"coalescing {cls.value}")
            eng.close()
    finally:
        rt.close()
    return HammerResult(
        "coalescing", sum(c["tx_count"] + c["rx_count"]
                          for c in counters.values()),
        sum(c["tx_bytes"] + c["rx_bytes"] for c in counters.values()),
        counters, extra={"bulk_wakeups_saved": saved,
                         "token_delay_p99_ms": tok_delay})


@_timed
def chaos(S: Stack, concurrent: bool) -> HammerResult:
    """Seeded delay / submit-error / drop faults on two-channel groups of
    four classes, 2 threads a class, 6 round trips of 16 KiB: every round
    trip exact, every logical byte counted once at the group, rings clean,
    every injected drop and submit error one ledger fault, no caller sees
    an error."""
    PC, F = S.runtime.PriorityClass, S.faults
    rt = S.runtime.TransferRuntime(workers=2)
    inj = F.FaultInjector(F.FaultPlan(seed=14, specs=(
        F.FaultSpec(kind="delay", p=0.10, delay_s=0.002),
        F.FaultSpec(kind="submit_error", p=0.05),
        F.FaultSpec(kind="drop", p=0.05, hold_s=0.0),
    )))
    rec = F.RecoveryConfig(max_retries=6, quarantine_after=10 ** 6,
                           drift_quarantine_ratio=None)
    classes = [PC.SENSOR, PC.TOKEN, PC.LAYER, PC.BULK]
    groups = {cls: S.channels.ChannelGroup(
        S.transfer.TransferPolicy.kernel_level_ring(3, block_bytes=1 << 14),
        n_channels=2, min_stripe_bytes=1 << 13,
        engine_factory=inj.engine_factory(), recovery=rec, runtime=rt,
        priority=cls, **S.group_kw(2)) for cls in classes}
    iters, n_elems = 6, 16 * 1024

    def hammer(cls, seed):
        g = groups[cls]
        x = np.full(n_elems, seed, np.uint8)
        for _ in range(iters):
            host = g.rx(g.tx(x))
            _equal(np.sort(_flat(host)), x, f"chaos {cls.value}")

    try:
        _run([lambda c=cls, i=i: hammer(c, i)
              for i, cls in enumerate(classes) for _ in range(2)], concurrent)
        _check(bool(inj.events), "chaos: the plan injected nothing")
        expected = 2 * iters * n_elems
        counters, total_faults = {}, 0
        for cls, g in groups.items():
            with g._stats_lock:
                stats = list(g.stats)
            c = {f"{d}_{k}": v for d in ("tx", "rx") for k, v in (
                ("bytes", sum(s.nbytes for s in stats if s.direction == d)),
                ("count", sum(1 for s in stats if s.direction == d)))}
            _check(c["tx_bytes"] == expected and c["rx_bytes"] == expected,
                   f"chaos {cls.value}: logical bytes {c}, want {expected}")
            f = g.fault_state.summary()
            _check(f["retry_successes"] <= f["retries"] <= f["faults"],
                   f"chaos {cls.value}: fault ledger {f}")
            total_faults += f["faults"]
            for eng in g.engines:
                _ring_clean(eng, f"chaos {cls.value}")
            counters[cls.value] = c
            g.close()
        injected = sum(1 for ev in inj.events
                       if ev[2] in ("drop", "submit_error"))
        _check(total_faults == injected, f"chaos: {total_faults} ledger "
               f"faults for {injected} injected drops / submit errors")
        s = rt.class_summary()
        for cls in classes:
            _check(s[cls.value]["completed"] > 0,
                   f"chaos {cls.value}: nothing completed")
    finally:
        rt.close()
    return HammerResult(
        "chaos", sum(c["tx_count"] + c["rx_count"] for c in counters.values()),
        2 * len(classes) * expected, counters,
        extra={"injected": len(inj.events), "faults": total_faults})


@_timed
def tenants(S: Stack, concurrent: bool) -> HammerResult:
    """4 tenants x 2 threads round-trip 32 KiB through ONE LAYER engine, 4
    times each, one tenant capped at 200 MB/s: every byte in its tenant's
    row, completed == submitted, nothing cancelled, no tenant left
    queued."""
    PC = S.runtime.PriorityClass
    rt = S.runtime.TransferRuntime(workers=2)
    eng = S.transfer.TransferEngine(S.transfer.TransferPolicy.kernel_level(),
                                    runtime=rt, priority=PC.LAYER,
                                    **S.engine_kw())
    names = ["t0", "t1", "t2", "t-capped"]
    rt.set_tenant_cap(PC.LAYER, "t-capped", 200e6, burst_s=0.01)
    n_threads_per, iters, n_elems = 2, 4, 8 * 1024
    per_rt = n_elems * 4 * 2  # tx + rx bytes per roundtrip

    def hammer(tenant, seed):
        spec = S.qos.QosSpec(tenant=tenant)
        x = np.full(n_elems, float(seed), np.float32)
        for _ in range(iters):
            dev = eng.tx_async(x, qos=spec).wait()
            host = eng.rx_async(dev, qos=spec).wait()
            _equal(_flat(host), x, f"tenants {tenant}")

    try:
        _run([lambda t=t, i=i: hammer(t, i)
              for i, t in enumerate(names) for _ in range(n_threads_per)],
             concurrent)
        expected = n_threads_per * iters * per_rt
        rows = rt.class_summary()["layer"]["tenants"]
        counters = {"engine": _engine_counters(eng)}
        for tenant in names:
            row = rows[tenant]
            _check(row["bytes_total"] == expected,
                   f"tenants {tenant}: {row['bytes_total']} B, want "
                   f"{expected}")
            _check(row["completed"] == row["submitted"]
                   and row["cancelled"] == 0,
                   f"tenants {tenant}: {row['completed']} of "
                   f"{row['submitted']} completed, {row['cancelled']} "
                   f"cancelled")
            counters[tenant] = {k: row[k] for k in (
                "submitted", "completed", "cancelled", "bytes_total")}
        _check(rows["t-capped"]["cap_bytes_per_s"] == 200e6,
               "tenants: the cap was lost")
        _check(rt.tenant_depth(PC.LAYER, "t0") == 0,
               "tenants: t0 still has queued work")
        _ring_clean(eng, "tenants")
        eng.close()
    finally:
        rt.close()
    c = counters["engine"]
    return HammerResult("tenants", c["tx_count"] + c["rx_count"],
                        len(names) * expected, counters)


def _feed(controller, model, repeats: int) -> None:
    for _ in range(repeats):
        for n in FEED_SIZES:
            controller.add_chunk_sample("tx", "interrupt", n,
                                        model.time_unique(n))


@_timed
def plan_swap(S: Stack, concurrent: bool) -> HammerResult:
    """8 threads round-trip 64 KiB through one engine and one adaptive
    group, 4 times in each of two phases; between the phases (every
    thread parked, the rings drained) the group is fed a 40x slower link
    and swaps its plan. No slot collision, no lost completion, bytes
    exact on the engine and the group."""
    CM = S.cost_model.TransferCostModel
    rt = S.runtime.TransferRuntime(workers=2)
    eng = S.transfer.TransferEngine(
        S.transfer.TransferPolicy.kernel_level_ring(3, block_bytes=1 << 14),
        runtime=rt, **S.engine_kw())
    group = S.adaptive.AdaptiveChannelGroup(
        8 << 20, model=CM(t0_s=100e-6, bw_Bps=2e9),
        cfg=S.adaptive.AdaptiveConfig(min_samples=8, refit_every=1),
        runtime=rt, **S.group_kw(1))
    n_threads, iters, n_elems = 8, 4, 16 * 1024
    per_tx = n_elems * 4
    barrier = threading.Barrier(n_threads + 1) if concurrent else None

    def phase(seed):
        x = np.full(n_elems, float(seed), np.float32)
        for _ in range(iters):
            dev = eng.tx_async(x).wait()
            _equal(_flat(eng.rx_async(dev).wait()), x, "plan_swap engine")
            chunks = group.tx(x)
            out = np.empty_like(x)
            group.rx(chunks, out=out)
            _equal(out, x, "plan_swap group")

    errors: list[BaseException] = []

    def hammer(seed):
        try:
            for p in range(2):
                barrier.wait(timeout=30)        # wait#1 / wait#2
                if p == 1:
                    barrier.wait(timeout=30)    # wait#3: main swapped
                phase(seed)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)
            barrier.abort()  # release the others and the main thread

    def swap() -> bool:
        _feed(group.controller, CM(t0_s=4e-3, bw_Bps=1e9), repeats=16)
        return group.maybe_adapt(force=True)

    try:
        if concurrent:
            threads = [threading.Thread(target=hammer, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            swapped = False
            try:
                barrier.wait(timeout=30)  # wait#1: phase 0 starts
                barrier.wait(timeout=30)  # wait#2: phase 0 done
                swapped = swap()
                barrier.wait(timeout=30)  # wait#3: phase 1 starts
            except threading.BrokenBarrierError as e:
                errors.append(e)
            for t in threads:
                t.join(JOIN_S)
            _check(not any(t.is_alive() for t in threads),
                   f"plan_swap: a thread ran past {JOIN_S} s")
            if errors:
                raise HammerError(f"plan_swap: {errors!r}") from errors[0]
        else:
            _run([lambda i=i: phase(i) for i in range(n_threads)], False)
            swapped = swap()
            _run([lambda i=i: phase(i) for i in range(n_threads)], False)
        _check(swapped and group.swaps >= 1, "plan_swap: no swap happened")
        for e in [eng] + group.all_engines:
            _ring_clean(e, "plan_swap")
            _check(e.inflight_hwm <= e.policy.depth,
                   f"plan_swap: {e.inflight_hwm} slots held")
        expected = n_threads * 2 * iters * per_tx
        c = _engine_counters(eng)
        _check(c["tx_bytes"] == expected and c["rx_bytes"] == expected,
               f"plan_swap engine: bytes {c}, want {expected}")
        with group._lock:
            stats = list(group.stats)
        hammer_tx = [s.nbytes for s in stats
                     if s.direction == "tx" and s.nbytes == per_tx]
        rx = [s.nbytes for s in stats if s.direction == "rx"]
        _check(sum(hammer_tx) == expected and sum(rx) == expected,
               f"plan_swap group: tx {sum(hammer_tx)}, rx {sum(rx)}, want "
               f"{expected}")
        counters = {"engine": c, "group": {
            "tx_bytes": sum(hammer_tx), "tx_count": len(hammer_tx),
            "rx_bytes": sum(rx), "rx_count": len(rx)}}
        swaps = group.swaps
    finally:
        eng.close()
        group.close()
        rt.close()
    return HammerResult(
        "plan_swap", c["tx_count"] + c["rx_count"] + len(hammer_tx) + len(rx),
        4 * expected, counters, extra={"swaps": swaps})


HAMMERS = (four_classes, coalescing, chaos, tenants, plan_swap)


def consumer_streams(S: Stack, n_channels: int, iters: int,
                     n_elems: int) -> HammerResult:
    """The card's own hammer. ``CONSUMER_THREADS`` threads share one engine
    (or, with ``n_channels`` > 1, one striped channel group); each works on
    a side stream of its own, ``iters`` times: spin ``CONSUMER_SPIN_CYCLES``
    and compute ``y = x * 3 + seed`` from the current TX result, drop the
    TX result (that kernel still queued), TX the next seeded int32
    payload (as a prefetch would), then RX ``y``. A dropped TX result must
    not be handed to a TX before the kernel queued on it has read it:
    every ``y`` is held bitwise against the host's ``x * 3 + seed``."""
    import torch

    dev = S.device
    _check(dev is not None and dev.type == "cuda",
           f"consumer_streams needs a CUDA device, got {dev}")
    t0 = time.perf_counter()
    rt = S.runtime.TransferRuntime(workers=2)
    policy = S.transfer.TransferPolicy.kernel_level_ring(4,
                                                         block_bytes=1 << 20)
    if n_channels == 1:
        transport = S.transfer.TransferEngine(policy, runtime=rt, device=dev)
        engines = [transport]
    else:
        transport = S.channels.ChannelGroup(policy, n_channels=n_channels,
                                            runtime=rt, **S.group_kw(
                                                n_channels))
        engines = transport.engines
    wrong: list[tuple[int, int]] = []
    wrong_lock = threading.Lock()

    def hammer(seed):
        rng = np.random.default_rng(seed)
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            x = rng.integers(0, 1 << 20, n_elems, dtype=np.int32)
            chunks = transport.tx_async(x).wait(30.0)
            for it in range(iters):
                torch.cuda._sleep(CONSUMER_SPIN_CYCLES)
                y = torch.cat(chunks) * 3 + seed
                del chunks
                x_next = rng.integers(0, 1 << 20, n_elems, dtype=np.int32)
                chunks = transport.tx_async(x_next).wait(30.0)
                back = transport.rx_async([y]).wait(30.0)
                del y
                if not np.array_equal(np.asarray(back[0]).reshape(-1),
                                      x * 3 + seed):
                    with wrong_lock:
                        wrong.append((seed, it))
                x = x_next

    try:
        _run([lambda i=i: hammer(i) for i in range(CONSUMER_THREADS)], True)
        c = {k: sum(_engine_counters(e)[k] for e in engines)
             for k in ("tx_bytes", "rx_bytes")}
        for e in engines:
            _ring_clean(e, "consumer_streams")
        transport.close()
    finally:
        rt.close()
    n = CONSUMER_THREADS * iters
    _check(not wrong, f"consumer_streams ({n_channels} channel(s)): "
           f"{len(wrong)} of {n} results are not the host's x * 3 + seed "
           f"(first (thread, iteration): {wrong[:8]})")
    nbytes = n * n_elems * 4
    _check(c["tx_bytes"] == nbytes + CONSUMER_THREADS * n_elems * 4
           and c["rx_bytes"] == nbytes,
           f"consumer_streams: bytes {c}, want {nbytes} RX and one more "
           f"payload a thread TX")
    return HammerResult(f"consumer_streams_{n_channels}ch",
                        2 * n + CONSUMER_THREADS, c["tx_bytes"] + c["rx_bytes"], c,
                        time.perf_counter() - t0,
                        extra={"mismatches": len(wrong)})
