"""The port's channel groups on the CPU, held against the reference's on
the same inputs: the planner's choices, the stripes and the RX assignment,
the staging pool, striped round trips of every transfer form, and the
streaming executor over a group."""

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # optional dep — degrade to the seeded fallback sampler
    from _hypothesis_fallback import given, settings, st

from repro.core.channels import ChannelGroup as JChannelGroup
from repro.core.channels import StagingPool as JStagingPool
from repro.core.channels import plan_channels as jplan_channels
from repro.core.cost_model import TransferCostModel as JTransferCostModel
from repro.core.transfer import LayoutCache as JLayoutCache
from repro.core.transfer import TransferPolicy as JTransferPolicy
from repro.core.transfer import reassemble_chunks as jreassemble_chunks
from repro_torch.core.channels import (
    ChannelGroup,
    StagingPool,
    calibrate_transfer,
    calibration_samples,
    plan_channels,
)
from repro_torch.core.cost_model import TransferCostModel
from repro_torch.core.streaming import HostStreamingExecutor
from repro_torch.core.transfer import (
    LayoutCache,
    TransferPolicy,
    reassemble_chunks,
)

# one intra-op thread: the suite's workers share the host's cores with
# timing-sensitive reference tests
torch.set_num_threads(1)

POLICY = dict(depth=4, block_bytes=1 << 16)


def _groups(n=2, min_stripe=1 << 14):
    """The same group in both packages (the port's on the CPU)."""
    g = ChannelGroup(TransferPolicy.kernel_level_ring(**POLICY),
                     n_channels=n, devices=["cpu"] * n,
                     min_stripe_bytes=min_stripe)
    jg = JChannelGroup(JTransferPolicy.kernel_level_ring(**POLICY),
                       n_channels=n, min_stripe_bytes=min_stripe)
    return g, jg


def _flat_bytes(arrays) -> np.ndarray:
    return np.concatenate([np.asarray(a).reshape(-1).view(np.uint8)
                           for a in arrays])


def _carried(group, direction):
    return [getattr(e, f"{direction}_bytes_total") for e in group.engines]


# ---- the planner --------------------------------------------------------

@pytest.mark.parametrize("t0_s,bw", [(10e-6, 8e9), (50e-6, 4e9),
                                     (2e-3, 1e9), (1e-6, 25e9)])
def test_plan_channels_matches_reference(t0_s, bw):
    """A pure function of the fitted model: the same plan on a grid of
    payloads (the os.cpu_count() cap is the same process's in both)."""
    for payload in (1, 4 << 10, 600_000, 1 << 20, 8 << 20, 48 << 20,
                    200 << 20):
        for max_ch in (1, 2, 4, 8):
            for preempt in (None, 1e-3):
                p = plan_channels(payload, model=TransferCostModel(t0_s, bw),
                                  max_channels=max_ch,
                                  preempt_target_s=preempt)
                j = jplan_channels(payload,
                                   model=JTransferCostModel(t0_s, bw),
                                   max_channels=max_ch,
                                   preempt_target_s=preempt)
                assert p.row() == j.row() and p.tag == j.tag
                assert p.policy.tag == j.policy.tag


def test_calibration_on_the_host_fits_a_positive_model():
    samples = calibration_samples("cpu", sizes=(4 << 10, 64 << 10, 1 << 20),
                                  repeats=1)
    assert [n for n, _, _ in samples] == [4 << 10, 64 << 10, 1 << 20]
    assert all(t > 0 and ev is None for _, t, ev in samples)
    m = calibrate_transfer("cpu", sizes=(4 << 10, 64 << 10, 1 << 20),
                           repeats=1)
    assert m.t0_s > 0 and m.bw_Bps > 0


def test_group_with_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChannelGroup(n_channels=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_transfer()
    with pytest.raises(ValueError, match="all the same"):
        ChannelGroup(n_channels=2, devices=["cpu"])


def test_group_device_is_its_channels():
    g, jg = _groups(3)
    try:
        assert g.device == torch.device("cpu")
        assert all(e.device == g.device for e in g.engines)
        assert not g.staging_pool.pin_memory  # pinned only on a card
    finally:
        g.close()
        jg.close()


# ---- stripes and the RX assignment ---------------------------------------

@pytest.mark.parametrize("n_channels", [1, 2, 3, 4])
def test_stripes_match_reference(n_channels):
    g, jg = _groups(n_channels)
    try:
        for n in (1, 1000, 8191, 8192, 100_003, 262_144, 1_000_001):
            x = np.arange(n, dtype=np.float32)
            for active in range(1, n_channels + 1):
                ours = [s.size for s in g._stripes(x, active)]
                ref = [s.size for s in jg._stripes(x, active)]
                assert ours == ref
    finally:
        g.close()
        jg.close()


@settings(max_examples=8, deadline=None)
@given(n_arrays=st.integers(2, 7), base=st.integers(1, 5000),
       n_channels=st.integers(2, 3))
def test_rx_assignment_matches_reference(n_arrays, base, n_channels):
    """Greedy byte-balanced RX: each channel carries the same arrays in
    both packages, and results come back in the original order."""
    g, jg = _groups(n_channels)
    try:
        arrays = [np.full(base * (3 * i % 5 + 1) + 4099, float(i),
                          np.float32) for i in range(n_arrays)]
        dev = [reassemble_chunks(g.tx(a)) for a in arrays]
        jdev = [jreassemble_chunks(jg.tx(a)) for a in arrays]
        before, jbefore = _carried(g, "rx"), _carried(jg, "rx")
        back, jback = g.rx(dev), jg.rx(jdev)
        for b, jb, a in zip(back, jback, arrays):
            np.testing.assert_array_equal(np.asarray(b).reshape(-1), a)
            np.testing.assert_array_equal(np.asarray(b), np.asarray(jb))
        got = [x - y for x, y in zip(_carried(g, "rx"), before)]
        ref = [x - y for x, y in zip(_carried(jg, "rx"), jbefore)]
        assert got == ref
    finally:
        g.close()
        jg.close()


# ---- striped round trips of every transfer form ---------------------------

@pytest.mark.parametrize("n_channels", [2, 3])
def test_striped_tx_rx_matches_reference(n_channels):
    g, jg = _groups(n_channels)
    try:
        x = np.random.default_rng(0).standard_normal(100_003).astype(
            np.float32)
        chunks, jchunks = g.tx(x), jg.tx(x)
        assert [c.numel() for c in chunks] == [c.size for c in jchunks]
        np.testing.assert_array_equal(reassemble_chunks(chunks).numpy(), x)
        assert _carried(g, "tx") == _carried(jg, "tx")
        back, jback = g.rx(chunks), jg.rx(jchunks)
        np.testing.assert_array_equal(_flat_bytes(back), _flat_bytes(jback))
        np.testing.assert_array_equal(_flat_bytes(back),
                                      x.view(np.uint8))
        assert _carried(g, "rx") == _carried(jg, "rx")
        # the flat zero-copy landing zone: the caller's own buffer
        out = np.empty_like(x)
        res = g.rx(chunks, out=out)
        np.testing.assert_array_equal(out, x)
        assert all(np.shares_memory(out, r) for r in res)
    finally:
        g.close()
        jg.close()


def test_striped_many_matches_reference():
    g, jg = _groups(3)
    try:
        arrays = [np.full(300 + 77 * i, i, np.int32) for i in range(7)]
        devs = [t.wait(5.0) for t in g.tx_many(arrays)]
        jdevs = [t.wait(5.0) for t in jg.tx_many(arrays)]
        for d, jd, a in zip(devs, jdevs, arrays):
            np.testing.assert_array_equal(d.numpy(), a)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert _carried(g, "tx") == _carried(jg, "tx")
        flat = np.empty(sum(a.size for a in arrays), np.int32)
        res = [t.wait(5.0) for t in g.rx_many(devs, out=flat)]
        jres = [t.wait(5.0) for t in jg.rx_many(jdevs)]
        np.testing.assert_array_equal(flat, np.concatenate(arrays))
        np.testing.assert_array_equal(_flat_bytes(res), _flat_bytes(jres))
        assert _carried(g, "rx") == _carried(jg, "rx")
    finally:
        g.close()
        jg.close()


def test_striped_sg_matches_reference():
    """Segments spread whole over the channels by byte load, in both
    packages alike; results in segment order, a flat out= carved."""
    g, jg = _groups(3)
    try:
        rng = np.random.default_rng(7)
        arrays = [rng.integers(0, 251, size=4096 + 512 * i).astype(
            np.float32) for i in range(9)]
        devs, jdevs = g.tx_sg(arrays).wait(10.0), jg.tx_sg(arrays).wait(10.0)
        for a, d, jd in zip(arrays, devs, jdevs):
            np.testing.assert_array_equal(d.numpy(), a)
            np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        assert _carried(g, "tx") == _carried(jg, "tx")
        assert all(b > 0 for b in _carried(g, "tx"))
        flat = np.empty(sum(a.nbytes for a in arrays), np.uint8)
        res = g.rx_sg(devs, out=flat).wait(10.0)
        jres = jg.rx_sg(jdevs).wait(10.0)
        np.testing.assert_array_equal(flat, _flat_bytes(arrays))
        np.testing.assert_array_equal(_flat_bytes(res), _flat_bytes(jres))
        assert _carried(g, "rx") == _carried(jg, "rx")
    finally:
        g.close()
        jg.close()


def test_sub_stripe_payload_rides_one_channel_like_reference():
    g, jg = _groups(4, min_stripe=1 << 20)
    try:
        x = np.arange(64, dtype=np.float32)
        np.testing.assert_array_equal(reassemble_chunks(g.tx(x)).numpy(), x)
        jg.tx(x)
        assert len(g.stats) == len(jg.stats) == 1
        assert sorted(_carried(g, "tx")) == sorted(_carried(jg, "tx"))
    finally:
        g.close()
        jg.close()


# ---- staging pool --------------------------------------------------------

def test_staging_pool_size_classes_match_reference():
    pool, jpool = StagingPool(), JStagingPool()
    sizes = (100, 4096, 4097, 5000, 1 << 20, (1 << 20) + 1, 3)
    bufs = [pool.acquire(n) for n in sizes]
    jbufs = [jpool.acquire(n) for n in sizes]
    assert [b.nbytes for b in bufs] == [b.nbytes for b in jbufs]
    for b, jb in zip(bufs[::2], jbufs[::2]):
        pool.release(b)
        jpool.release(jb)
    again = [pool.acquire(n) for n in sizes]
    jagain = [jpool.acquire(n) for n in sizes]
    assert [b.nbytes for b in again] == [b.nbytes for b in jagain]
    assert (pool.allocations, pool.reuses) == (jpool.allocations,
                                               jpool.reuses)


def test_staging_pool_recycles_on_layout_eviction_like_reference():
    counts = []
    for pool_cls, cache_cls in ((StagingPool, LayoutCache),
                                (JStagingPool, JLayoutCache)):
        pool = pool_cls()
        cache = cache_cls(pool=pool)
        lay1 = cache.get("k", [np.zeros(10_000, np.float32)])
        buf1 = lay1._staging
        # same key, new shapes in the same size class: the evicted
        # layout's buffer is pooled and handed to the new one
        lay2 = cache.get("k", [np.zeros(9_000, np.float32)])
        assert lay2 is not lay1 and lay2._staging is buf1
        # a third, larger class allocates
        cache.get("k", [np.zeros(100_000, np.float32)])
        counts.append((pool.allocations, pool.reuses))
    assert counts[0] == counts[1] == (2, 1)


def test_group_layouts_stage_from_the_pool():
    g, jg = _groups(2)
    try:
        arrays = [np.random.default_rng(1).standard_normal((257, 33)).astype(
            np.float32), np.arange(1001, dtype=np.int32)]
        lay = g.layouts.get("layer0", arrays)
        out = lay.unpack(g.tx(lay.pack(arrays)))
        for o, a in zip(out, arrays):
            np.testing.assert_array_equal(o.numpy(), a)
        assert g.staging_pool.allocations == 1
    finally:
        g.close()
        jg.close()


# ---- the streaming executor over a group ----------------------------------

def test_group_runs_streaming_executor_like_reference():
    """The reference's test_group_runs_streaming_executor scenario: four
    32x32 tanh layers through the three-way overlap executor over a
    two-channel group, the same weights and input in both packages."""
    import jax
    import jax.numpy as jnp

    from repro.core.streaming import HostStreamingExecutor as JExecutor

    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((32, 32)).astype(np.float32) for _ in range(4)]
    x = rng.standard_normal((2, 32)).astype(np.float32)
    jfn = jax.jit(lambda params, h: jnp.tanh(h @ params[0]))
    g, jg = _groups(2)
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
