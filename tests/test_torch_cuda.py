"""The port on the card: each CUDA kernel against its plain version, the
transfer engine's copy streams, and one NullHop frame. Every test here is
marked ``cuda`` and skips where there is no GPU. The file imports neither
jax nor the reference package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.accel.nullhop import NullHopExecutor
from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.core.transfer import (
    Buffering,
    Management,
    Partitioning,
    TransferEngine,
    TransferPolicy,
)
from repro_torch.kernels.conv2d.kernel import CONV2D
from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref
from repro_torch.kernels.streamed_matmul.kernel import (
    MATMUL,
    TILES,
    matmul_blocks,
    matmul_unique,
)
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

pytestmark = pytest.mark.cuda

# the five RoShamBo layers (hw, cin, cout)
ROSHAMBO = [(64, 1, 16), (32, 16, 32), (16, 32, 64), (8, 64, 128),
            (4, 128, 128)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # the plain references must stay float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hw,cin,cout", ROSHAMBO)
def test_conv2d_kernel_matches_plain(dev, hw, cin, cout, dtype, tol):
    g = torch.Generator().manual_seed(hw + cin)
    x = torch.randn((2, hw, hw, cin), generator=g).to(dev, dtype)
    w = (torch.randn((3, 3, cin, cout), generator=g) * 0.2).to(dev, dtype)
    b = (torch.randn((cout,), generator=g) * 0.1).to(dev, dtype)
    before = CONV2D.launches["conv2d_bias_act"]
    got = conv2d_relu(x, w, b, relu=False)
    assert CONV2D.launches["conv2d_bias_act"] == before + 1
    torch.testing.assert_close(got.float(),
                               conv2d_relu_ref(x, w, b, relu=False).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("tile", TILES)
def test_matmul_kernels_match_plain(dev, tile):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((100, 70), generator=g).to(dev)
    w = torch.randn((70, 33), generator=g).to(dev)
    bm, bn, bk = tile
    before = dict(MATMUL.launches)
    torch.testing.assert_close(
        matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk),
        matmul_ref(x, w), rtol=2e-4, atol=2e-3)
    torch.testing.assert_close(matmul_unique(x, w), matmul_ref(x, w),
                               rtol=2e-4, atol=2e-3)
    assert MATMUL.launches["matmul_blocks"] == before["matmul_blocks"] + 1
    assert MATMUL.launches["matmul_unique"] == before["matmul_unique"] + 1


def test_kernel_refuses_non_contiguous(dev):
    x = torch.zeros((1, 8, 8, 4), device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_relu(x, torch.zeros((3, 3, 4, 4), device=dev),
                    torch.zeros(4, device=dev))


@pytest.mark.parametrize("m", list(Management))
def test_engine_roundtrip_on_card(dev, m):
    eng = TransferEngine(TransferPolicy(m, Buffering.DOUBLE,
                                        Partitioning.BLOCKS,
                                        block_bytes=1 << 12))
    assert eng.device.type == "cuda"
    a = [np.arange(1000, dtype=np.float32), np.ones((3, 5), np.int32)]
    lay = eng.layouts.get("k", a)
    assert lay._staging_t is not None and lay._staging_t.is_pinned()
    dev_arrays = lay.unpack(eng.tx(lay.pack(a)))
    assert all(t.is_cuda for t in dev_arrays)
    outs = [np.empty_like(x) for x in a]
    got = eng.rx(dev_arrays, out=outs)
    for g_, o, x in zip(got, outs, a):
        assert g_ is o
        np.testing.assert_array_equal(o, x)
    eng.close()


def test_nullhop_frame_on_card(dev):
    cnn = RoShamBoCNN()
    params = cnn.init(torch.Generator().manual_seed(1), device=dev)
    frame = np.random.default_rng(1).standard_normal(
        (1, 64, 64, 1)).astype(np.float32)
    ref = cnn.apply(params, torch.from_numpy(frame).to(dev)).cpu().numpy()
    ex = NullHopExecutor(cnn, TransferPolicy.kernel_level_ring())
    try:
        before = CONV2D.launches["conv2d_bias_act"]
        res = ex.run_frame(params, frame)
    finally:
        ex.close()
    assert CONV2D.launches["conv2d_bias_act"] == before + 10
    np.testing.assert_allclose(res.logits, ref, rtol=1e-4, atol=1e-4)
