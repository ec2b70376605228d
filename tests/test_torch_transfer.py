"""The port's transfer engine on the CPU: the policy matrix round-trips
bytes exactly, RX lands in the caller's buffer, and a TX result never
aliases the staging buffer it came from. Held against the reference engine
on the same inputs where the two expose the same numbers."""

import threading

import numpy as np
import pytest
import torch

from repro.core.transfer import (
    Buffering as JBuffering,
    Management as JManagement,
    Partitioning as JPartitioning,
    TransferEngine as JTransferEngine,
    TransferPolicy as JTransferPolicy,
)
from repro_torch.core.streaming import _unpack
from repro_torch.core.transfer import (
    Buffering,
    BufferInFlightError,
    Management,
    Partitioning,
    StagedLayout,
    TransferEngine,
    TransferPolicy,
    _bitcast_from_bytes,
    reassemble_chunks,
)

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

MATRIX = [(m, b, p) for m in Management for b in Buffering
          for p in Partitioning]


def _engine(m, b, p, block_bytes=1 << 12):
    return TransferEngine(TransferPolicy(m, b, p, block_bytes=block_bytes),
                          device="cpu")


@pytest.mark.parametrize("m,b,p", MATRIX,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_roundtrip_matches_reference(m, b, p):
    x = (np.arange(5000) % 251).astype(np.float32)
    eng = _engine(m, b, p)
    chunks = eng.tx(x)
    assert all(isinstance(c, torch.Tensor) and c.device.type == "cpu"
               for c in chunks)
    back = eng.rx(chunks)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a).reshape(-1) for a in back]), x)
    ref = JTransferEngine(JTransferPolicy(JManagement(m.value),
                                          JBuffering(b.value),
                                          JPartitioning(p.value),
                                          block_bytes=1 << 12))
    ref_chunks = ref.tx(x)
    assert [c.numel() for c in chunks] == [int(c.size) for c in ref_chunks]
    assert [(s.direction, s.nbytes, s.n_chunks) for s in eng.stats] == \
        [(s.direction, s.nbytes, s.n_chunks) for s in ref.stats] + \
        [("rx", x.nbytes, len(chunks))]
    eng.close()
    ref.close()


@pytest.mark.parametrize("m,b,p", MATRIX,
                         ids=lambda v: getattr(v, "value", str(v)))
def test_rx_out_lands_in_callers_buffer(m, b, p):
    eng = _engine(m, b, p)
    y = torch.arange(300, dtype=torch.float32).reshape(10, 30)
    out = np.zeros((10, 30), np.float32)
    got = eng.rx([y], out=[out])
    assert got[0] is out
    np.testing.assert_array_equal(out, y.numpy())
    eng.close()


def test_rx_without_out_is_a_copy():
    eng = _engine(Management.POLLING, Buffering.SINGLE, Partitioning.UNIQUE)
    y = torch.ones(16)
    host = eng.rx([y])[0]
    y.fill_(7.0)
    np.testing.assert_array_equal(host, np.ones(16, np.float32))


@pytest.mark.parametrize("m", list(Management))
def test_cpu_tx_does_not_alias_staging_buffer(m):
    """Regression: on the CPU a "TX" out of the reused StagedLayout staging
    buffer must copy, or the next pack overwrites an earlier layer's
    params."""
    eng = TransferEngine(TransferPolicy(m, Buffering.SINGLE,
                                        Partitioning.UNIQUE), device="cpu")
    a = [np.full((4, 4), 1.0, np.float32), np.arange(4, dtype=np.float32)]
    lay = eng.layouts.get("conv1", a)
    first = lay.unpack(eng.tx(lay.pack(a)))
    kept = [t.clone() for t in first]
    b = [np.full((4, 4), 9.0, np.float32), -np.arange(4, dtype=np.float32)]
    lay.pack(b)
    for t, k in zip(first, kept):
        assert torch.equal(t, k)
    second = lay.unpack(eng.tx(lay.pack(b, force=True)))
    assert torch.equal(second[0], torch.full((4, 4), 9.0))
    eng.close()


def test_staged_layout_unpack_mixed_dtypes():
    arrays = [np.arange(6, dtype=np.float32).reshape(2, 3),
              np.array([1, 0, 1], np.bool_), np.arange(5, dtype=np.uint8),
              np.arange(4, dtype=np.int32)]
    lay = StagedLayout(arrays[:1] + arrays[2:3] + arrays[1:2])
    eng = _engine(Management.INTERRUPT, Buffering.DOUBLE, Partitioning.BLOCKS,
                  block_bytes=8)
    got = lay.unpack(eng.tx(lay.pack(arrays[:1] + arrays[2:3] + arrays[1:2])))
    np.testing.assert_array_equal(got[0].numpy(), arrays[0])
    np.testing.assert_array_equal(got[1].numpy(), arrays[2])
    np.testing.assert_array_equal(got[2].numpy(), arrays[1])
    # the seed-path unpack agrees
    flat = eng.tx(np.concatenate([a.reshape(-1).view(np.uint8)
                                  for a in arrays]))
    for t, a in zip(_unpack(flat, arrays), arrays):
        np.testing.assert_array_equal(t.numpy(), a)
    eng.close()


def test_bitcast_raises_on_misaligned_offset():
    flat = torch.zeros(16, dtype=torch.uint8)
    assert _bitcast_from_bytes(flat[4:12], (2,), np.dtype(np.float32)).shape \
        == (2,)
    with pytest.raises(ValueError, match="aligned"):
        _bitcast_from_bytes(flat[2:10], (2,), np.dtype(np.float32))


def test_reassemble_chunks_order():
    chunks = [torch.arange(3), torch.arange(3, 7)]
    assert torch.equal(reassemble_chunks(chunks), torch.arange(7))


def test_async_many_and_sg_roundtrip():
    eng = _engine(Management.INTERRUPT, Buffering.RING, Partitioning.BLOCKS)
    x = np.random.default_rng(0).standard_normal(3000).astype(np.float32)
    flat = reassemble_chunks(eng.tx_async(x).wait())
    np.testing.assert_array_equal(flat.numpy(), x)
    back = eng.rx_async([flat]).wait()
    np.testing.assert_array_equal(back[0], x)
    arrays = [np.full(7, i, np.int32) for i in range(5)]
    devs = [t.wait() for t in eng.tx_many(arrays)]
    outs = [np.zeros(7, np.int32) for _ in arrays]
    hosts = [t.wait() for t in eng.rx_many(devs, out=outs)]
    for h, o, a in zip(hosts, outs, arrays):
        assert h is o
        np.testing.assert_array_equal(o, a)
    sg = eng.tx_sg([arrays[0], (arrays[1], 4, 12)]).wait()
    assert sg[0].shape == (7,) and sg[1].tolist() == [1, 1, 1]
    flat_out = np.zeros(56, np.uint8)
    eng.rx_sg([devs[0], devs[1]], out=flat_out).wait()
    np.testing.assert_array_equal(flat_out.view(np.int32),
                                  np.concatenate(arrays[:2]))
    eng.close()


def test_busy_layout_repack_raises():
    eng = _engine(Management.INTERRUPT, Buffering.DOUBLE, Partitioning.UNIQUE)
    a = [np.ones(8, np.float32)]
    lay = eng.layouts.get("k", a)
    eng.tx_async(lay.pack(a), layout=lay).wait()
    lay._busy = threading.Event()  # a transfer still in flight
    with pytest.raises(BufferInFlightError):
        lay.pack(a, wait=False)
    eng.close()


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransferEngine(TransferPolicy.user_level_polling())


def test_checksum_policy_verifies_rx():
    eng = TransferEngine(TransferPolicy(checksum=True), device="cpu")
    y = torch.arange(64, dtype=torch.float32)
    np.testing.assert_array_equal(eng.rx([y])[0], y.numpy())
    assert eng.summary()["checksum_failures"] == 0
    eng.close()
