"""The paper's experiment, end to end: compare the driver modes on a
streamed per-layer CNN execution (NullHop + RoShamBo) and print a Table-I
style summary — then demo the SAME three modes as backends of the unified
TransferRuntime submit contract, with concurrent SENSOR-class frame
collection and the runtime's per-class QoS ledger, completion coalescing,
and self-healing channels under injected faults.

    PYTHONPATH=src python -m repro_torch.examples.transfer_modes \
        [--device cpu]

The port's counterpart of ``examples/transfer_modes.py``: the same
policies, frame, demos and printed lines, on the card unless ``--device
cpu`` is given. Params come from a ``torch.Generator`` seeded 0, the frame
from ``np.random.default_rng(0)``. Each demo also returns what it printed
as a dict, and :func:`main` returns them all.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.accel.nullhop import NullHopExecutor
from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.core import (
    Buffering,
    Management,
    Partitioning,
    PriorityClass,
    QosSpec,
    TransferEngine,
    TransferPolicy,
    TransferRuntime,
)
from repro_torch.core.runtime import backend_for
from repro_torch.core.transfer import Ticket
from repro_torch.device import default_device

POLICIES = [
    ("user-level polling", TransferPolicy.user_level_polling()),
    ("user-level drv scheduled", TransferPolicy.user_level_scheduled()),
    ("kernel-level drv", TransferPolicy.kernel_level()),
    ("kernel drv + double/blocks", TransferPolicy(
        Management.INTERRUPT, Buffering.DOUBLE, Partitioning.BLOCKS,
        block_bytes=1 << 16)),
]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    cnn = RoShamBoCNN()
    params = cnn.init(torch.Generator().manual_seed(0), device=device)
    frame = np.random.default_rng(0).standard_normal(
        (1, 64, 64, 1)).astype(np.float32)
    return {"table_i": table_i(cnn, params, frame, device),
            "unified": demo_unified_runtime(device),
            "coalescing": demo_coalescing(device),
            "faults": demo_fault_injection(device)}


def table_i(cnn: RoShamBoCNN, params: dict, frame: np.ndarray,
            device) -> dict:
    """Each policy's best of 3 frames after a warm-up frame: a row of TX /
    RX us a byte and frame ms, with its logits; the last policy's
    per-layer output sparsity."""
    print(f"{'mode':28s} {'TX us/B':>9s} {'RX us/B':>9s} {'frame ms':>9s}")
    rows = []
    best = None
    for name, policy in POLICIES:
        ex = NullHopExecutor(cnn, policy, device=device)
        try:
            ex.run_frame(params, frame)  # warm-up
            best = None
            for _ in range(3):
                res = ex.run_frame(params, frame)
                if best is None or res.timing.frame_s < best.timing.frame_s:
                    best = res
        finally:
            ex.close()
        t = best.timing
        print(f"{name:28s} {t.tx_us_per_byte:9.4f} {t.rx_us_per_byte:9.4f} "
              f"{t.frame_s * 1e3:9.2f}")
        rows.append({"mode": name, "policy": policy.tag,
                     "tx_us_per_B": t.tx_us_per_byte,
                     "rx_us_per_B": t.rx_us_per_byte,
                     "frame_ms": t.frame_s * 1e3, "logits": best.logits})
    print("\nper-layer output sparsity (NullHop skips zeros):",
          [round(s, 2) for s in best.sparsity])
    return {"rows": rows, "sparsity": best.sparsity}


def _put(x: np.ndarray, device) -> torch.Tensor:
    """A host -> device copy of ``x``, complete on return: the copy on the
    current stream, then that stream synchronised."""
    src = torch.from_numpy(x)
    out = torch.empty_like(src, device=device)
    out.copy_(src)
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()
    return out


def demo_unified_runtime(device) -> dict:
    """The paper's three managements as three backends of ONE submit
    contract: ``submit(fn) -> (done, out)``, wrapped by the same Ticket."""
    print("\n== unified runtime: one submit contract, three backends ==")
    x = np.random.default_rng(0).standard_normal(1 << 18).astype(np.float32)
    out: dict = {"submit_ms": {}}
    with TransferRuntime(workers=2) as rt:
        for mode in ("polling", "scheduled", "interrupt"):
            backend = backend_for(mode, runtime=rt,
                                  priority=PriorityClass.LAYER)
            t0 = time.perf_counter()
            done, res = backend.submit(lambda: _put(x, device),
                                       nbytes=x.nbytes)
            if hasattr(backend, "drain"):  # scheduled: runs on the caller
                backend.drain()
            Ticket(done, res).wait()
            ms = (time.perf_counter() - t0) * 1e3
            out["submit_ms"][mode] = ms
            print(f"  {mode:10s} submit->complete {ms:7.2f} ms")

        # QoS arbitration: TOKEN-class RX rides ahead of bulk LAYER TX
        # while a SENSOR-class background task keeps collecting "events"
        events = {"n": 0}
        unregister = rt.register_background(
            lambda: events.__setitem__("n", events["n"] + 1))
        bulk_eng = TransferEngine(TransferPolicy.kernel_level_ring(4),
                                  device=device, runtime=rt,
                                  priority=PriorityClass.LAYER)
        tok_eng = TransferEngine(TransferPolicy.kernel_level(),
                                 device=device, runtime=rt,
                                 priority=PriorityClass.TOKEN)
        tok_dev = tok_eng.tx(np.arange(8, dtype=np.int32))
        tok_out = np.empty(8, np.int32)
        stop = threading.Event()

        def flood():
            while not stop.is_set():
                bulk_eng.tx_async(x).wait()

        t = threading.Thread(target=flood, daemon=True)
        t.start()
        # the QosSpec submit context: class + tenant on one object
        tok_qos = QosSpec(priority=PriorityClass.TOKEN, tenant="demo")
        lats = []
        try:
            for _ in range(50):
                t0 = time.perf_counter()
                tok_eng.rx_async(tok_dev, out=[tok_out], qos=tok_qos).wait()
                lats.append(time.perf_counter() - t0)
                time.sleep(0.002)
        finally:
            stop.set()
            t.join(timeout=10)
            unregister()
        lats.sort()
        out.update({"token_rx_p50_ms": lats[len(lats) // 2] * 1e3,
                    "token_rx_max_ms": lats[-1] * 1e3,
                    "sensor_slices": events["n"]})
        print(f"  token RX under bulk flood: p50 "
              f"{out['token_rx_p50_ms']:.2f} ms, max "
              f"{out['token_rx_max_ms']:.2f} ms; sensor slices "
              f"{events['n']}")
        print("  per-class ledger:")
        summary = rt.class_summary()
        for cls, row in summary.items():
            print(f"    {cls:7s} n={row['completed']:<5d} "
                  f"bytes={row['bytes_total']:<12d} "
                  f"dispatch p99 {row['dispatch_p99_ms']:.3f} ms")
        out["classes"] = {cls: {"completed": row["completed"],
                                "bytes_total": row["bytes_total"]}
                          for cls, row in summary.items()}
        demo_row = summary["token"]["tenants"].get("demo")
        if demo_row:
            print(f"    token tenant 'demo': n={demo_row['completed']} "
                  f"bytes={demo_row['bytes_total']} dispatch p99 "
                  f"{demo_row['dispatch_p99_ms']:.3f} ms")
            out["tenant_demo"] = {"completed": demo_row["completed"],
                                  "bytes_total": demo_row["bytes_total"]}
        bulk_eng.close()
        tok_eng.close()
    return out


def demo_coalescing(device) -> dict:
    """Batched descriptor submission + completion coalescing: 32 token-
    sized RX descriptors as singles vs ONE rx_many ring transaction, and
    the per-class wakeup ledger a BULK burst leaves behind (see
    docs/coalescing.md)."""
    print("\n== coalescing: batched submission + completion vectors ==")
    n, elems = 32, 1024  # 32 descriptors x 4 KiB
    with TransferRuntime(workers=2) as rt:
        eng = TransferEngine(TransferPolicy.kernel_level_ring(8),
                             device=device, runtime=rt,
                             priority=PriorityClass.TOKEN)
        arrays = [np.arange(elems, dtype=np.int32) + i for i in range(n)]
        devs = [t.wait() for t in eng.tx_many(arrays)]
        outs = [np.empty(elems, np.int32) for _ in range(n)]
        eng.rx_many(devs[:2], out=outs[:2])[1].wait()  # warm the RX path

        t0 = time.perf_counter()
        for d, o in zip(devs, outs):
            eng.rx_async([d], out=[o]).wait()
        singles_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for t in eng.rx_many(devs, out=outs):
            t.wait()
        batched_s = time.perf_counter() - t0
        ratio = singles_s / max(batched_s, 1e-9)
        print(f"  32 x 4 KiB token RX: singles "
              f"{singles_s / n * 1e6:6.1f} us/desc, one rx_many batch "
              f"{batched_s / n * 1e6:6.1f} us/desc ({ratio:.1f}x)")

        # completion vectors: a burst of BULK completions -> few wakeups
        h = rt.register("burst", PriorityClass.BULK)
        pairs = [h.submit(lambda: 1, nbytes=4096) for _ in range(64)]
        for ev, _out in pairs:
            ev.wait()
        row = rt.class_summary()["bulk"]
        print(f"  64 BULK completions -> {row['completion_wakeups']} "
              f"wakeups ({row['wakeups_saved']} saved, batch p50 "
              f"{row['coalesce_batch_p50']:.0f}, added delay p99 "
              f"{row['coalesce_delay_p99_ms']:.2f} ms)")
        h.close()
        eng.close()
    return {"singles_us_per_desc": singles_s / n * 1e6,
            "batched_us_per_desc": batched_s / n * 1e6, "ratio": ratio,
            "bulk_wakeups": row["completion_wakeups"],
            "wakeups_saved": row["wakeups_saved"],
            "rx_bitwise": all(np.array_equal(o, a)
                              for o, a in zip(outs, arrays))}


def demo_fault_injection(device) -> dict:
    """Self-healing under injected faults: a striped ChannelGroup retries
    dropped descriptors on sibling channels, quarantines a channel that
    keeps failing, and keeps every byte accounted for — all driven by the
    deterministic, seeded :class:`~repro_torch.core.faults.FaultInjector`."""
    from repro_torch.core.channels import ChannelGroup
    from repro_torch.core.faults import (
        FaultInjector, FaultPlan, FaultSpec, RecoveryConfig)

    print("\n== fault injection: retry on sibling, quarantine, heal ==")
    # channel 0 drops its first two descriptors, then behaves; two
    # consecutive faults trip the quarantine threshold
    inj = FaultInjector(FaultPlan(seed=7, specs=(
        FaultSpec(kind="drop", channel=0, max_injections=2),)))
    g = ChannelGroup(
        # 2 MiB blocks: each ~1.3 MiB stripe is ONE descriptor, so the two
        # scheduled drops land on two separate transfers (two consecutive
        # stripe-level faults), not inside one stripe's chunk chain
        TransferPolicy.kernel_level_ring(4, block_bytes=1 << 21),
        n_channels=3, devices=[device] * 3,
        engine_factory=inj.engine_factory(),
        recovery=RecoveryConfig(quarantine_after=2, max_retries=2,
                                drift_quarantine_ratio=None,
                                probe_interval_s=0.0))
    # 4 MiB: comfortably above 2x the minimum stripe size, so the payload
    # stripes across all three channels (sub-stripe traffic takes the
    # single-channel delegated path, which has no sibling to retry on)
    x = np.random.default_rng(1).standard_normal(1 << 20).astype(np.float32)
    try:
        for _ in range(3):
            g.tx(x)  # faulted stripes transparently retry on a sibling
        after_tx = sorted(g.quarantined)
        print(f"  after 3 striped TX: quarantined={after_tx} "
              f"(channel 0 pulled after 2 consecutive drops)")
        g.check_channel_health()  # probe succeeds -> channel 0 rejoins
        after_probe = sorted(g.quarantined)
        print(f"  after probe:        quarantined={after_probe}")
        ledger = g.fault_state.summary()
        ledger = {k: ledger[k] for k in (
            "faults", "retries", "retry_successes", "quarantines",
            "unquarantines")}
        print("  fault ledger:", ledger)
        events = [(c, op, kind) for c, op, kind, *_ in inj.events]
        print("  injected events:", events)
    finally:
        g.close()
    return {"quarantined_after_tx": after_tx,
            "quarantined_after_probe": after_probe, "ledger": ledger,
            "events": events}


if __name__ == "__main__":
    main()
