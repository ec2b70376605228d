"""The counts against hand-worked values."""

from __future__ import annotations

from perfbench.counts import cnn, conv2d, lm, peaks
from perfbench.lib import spec


def test_one_conv2d_launch():
    # conv2 at batch 1: 32x32 output, 16 -> 32 channels, 3x3
    assert conv2d.flops(1, 32, 32, 16, 32) == (
        2 * 32 * 32 * 16 * 32 * 9 + 2 * 32 * 32 * 32)  # 9,502,720
    assert conv2d.flops(1, 32, 32, 16, 32) == 9_502_720
    # in 32*32*16 + w 9*16*32 + b 32 + out 32*32*32, 4 bytes each
    assert conv2d.nbytes(1, 32, 32, 16, 32) == 4 * (16384 + 4608 + 32 + 32768)
    # f32 bound: 9.5 MFLOP / 67e12 = 1.418e-7 s > 215,168 B / 3.35e12
    least = peaks.least_s(9_502_720, 215_168, peaks.F32_FLOPS)
    assert abs(least - 9_502_720 / 67e12) < 1e-18


def test_roshambo_frame():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "roshambo-nullhop.json")
    assert cnn.conv_shapes(cfg, 1) == [
        (1, 64, 64, 1, 16), (1, 32, 32, 16, 32), (1, 16, 16, 32, 64),
        (1, 8, 8, 64, 128), (1, 4, 4, 128, 128)]
    assert cnn.feature_size(cfg) == 2048
    # MACs: 4096*144 + 1024*4608 + 256*18432 + 64*73728 + 16*147456
    macs = 589_824 + 4_718_592 + 4_718_592 + 4_718_592 + 2_359_296
    assert cnn.frame_flops(cfg) == 2 * macs + 2 * 2048 * 4  # ~34.2 MFLOP


def test_granite_step():
    cfg = spec.load_json(spec.BENCH_DIR / "configs"
                         / "granite-moe-1b-a400m.json")
    # a layer a token: q, o 1024x1024; k, v 1024x512; router 1024x32;
    # 8 experts of 1024x1024 up and 512x1024 down
    layer = 2 * (2 * 1024 * 1024 + 2 * 1024 * 512) + 2 * 1024 * 32 \
        + 8 * (2 * 1024 * 1024 + 2 * 512 * 1024)
    assert layer == 6_291_456 + 65_536 + 25_165_824
    head = 2 * 1024 * 49155
    assert lm.dense_flops_per_token(cfg) == 24 * layer + head
    # attention: 24 layers x 16 heads x 4 x 64 per key seen
    assert lm.decode_flops(cfg, 100) == (lm.dense_flops_per_token(cfg)
                                         + 24 * 16 * 256 * 100)
    # B 2 x S 8192 with recomputation: 4 forwards
    s = 8192
    fwd = s * (24 * layer + head) + 24 * 16 * 256 * s * (s + 1) // 2
    assert lm.train_step_flops(cfg, 2, s) == 4 * 2 * fwd
    assert 82e12 < lm.train_step_flops(cfg, 2, s) < 83e12  # 82.57 TFLOP
