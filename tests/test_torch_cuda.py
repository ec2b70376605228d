"""The port on the card: each CUDA kernel against its plain version, the
transfer engine's copy streams, one NullHop frame, and a small dense LM
through the flash kernel and the serving engine. Every test here is
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
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels.conv2d.kernel import CONV2D
from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref
from repro_torch.kernels.streamed_matmul.kernel import (
    MATMUL,
    TILES,
    matmul_blocks,
    matmul_unique,
)
from repro_torch.kernels.flash_attention.kernel import FLASH
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.streamed_matmul.ref import matmul_ref
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeConfig, ServingEngine

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


def test_matmul_unique_grid_path_matches_plain(dev):
    # over one block's shared memory, within the 96 MiB UNIQUE budget
    g = torch.Generator().manual_seed(1)
    x = torch.randn((256, 384), generator=g).to(dev)
    w = torch.randn((384, 512), generator=g).to(dev)
    torch.testing.assert_close(matmul_unique(x, w), matmul_ref(x, w),
                               rtol=2e-4, atol=2e-3)


# f32: rtol = atol = 2e-4. bf16: rtol 2e-2 and an atol of 0.05 x the RMS
# of each plain output row, which scales with the row (chip_smoke.py's rule)
FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, None)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", [
    (2, 128, 128, 16, 2, 128, True, 0),
    (1, 512, 512, 8, 2, 80, True, 96),
    (2, 100, 250, 4, 2, 64, False, 0),
    (1, 333, 333, 4, 1, 160, True, 0),
])
def test_flash_kernel_matches_plain(dev, b, sq, skv, h, hkv, d, causal,
                                    window, dtype):
    g = torch.Generator().manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), generator=g).to(dev, dtype)
    k = torch.randn((b, skv, hkv, d), generator=g).to(dev, dtype)
    v = torch.randn((b, skv, hkv, d), generator=g).to(dev, dtype)
    before = FLASH.launches["flash_attention_fwd"]
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert FLASH.launches["flash_attention_fwd"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=causal, window=window).float()
    rtol, atol = FLASH_TOL[dtype]
    if atol is None:
        atol = 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + rtol * ref.abs()).all()), float(diff.max())


def _small_lm(**over):
    # head dim 64, one the kernel is built for (the smoke config's is 16)
    cfg = smoke_config("qwen2.5-3b").replace(
        d_model=256, n_heads=4, n_kv_heads=2, dtype="float32", **over)
    return cfg, build_model(cfg)


def test_lm_forward_through_flash_matches_plain(dev):
    cfg, plain = _small_lm()
    flash = build_model(cfg.replace(use_pallas_attention=True))
    params = plain.init(torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96))).to(dev)
    before = FLASH.launches["flash_attention_fwd"]
    lf, _ = flash.forward(params, {"tokens": toks})
    assert FLASH.launches["flash_attention_fwd"] == before + cfg.n_layers
    lp, _ = plain.forward(params, {"tokens": toks})
    torch.testing.assert_close(lf, lp, rtol=0, atol=1e-4)


def test_serving_on_card_is_policy_independent(dev):
    cfg, model = _small_lm()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                                dtype=np.int32)
    got = []
    for policy in (TransferPolicy.kernel_level(),
                   TransferPolicy.user_level_polling()):
        eng = ServingEngine(model, params, ServeConfig(max_seq=48),
                            policy=policy)
        try:
            assert eng.engine.device.type == "cuda"
            got.append(np.stack([r.tokens for r in eng.generate(prompts, 12)]))
        finally:
            eng.close()
    np.testing.assert_array_equal(got[0], got[1])
