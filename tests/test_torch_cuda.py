"""The port on the card: each CUDA kernel against its plain version, the
transfer engine's copy streams, channel groups (striped round trips, the
caller's stream before a striped RX, pinned pool staging, calibration,
injected faults and their recovery), one NullHop frame, a small dense LM
through the flash kernel and the serving engine, and the smoke mamba2 /
zamba2 models through the SSD kernel. Every test here is
marked ``cuda`` and skips where there is no GPU. The file imports neither
jax nor the reference package, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import contextlib
import dataclasses
import itertools
import math
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.accel.nullhop import NullHopExecutor
from repro_torch.analysis import stress
from repro_torch.accel.roshambo import RoShamBoCNN
from repro_torch.core.channels import ChannelGroup, calibrate_transfer
from repro_torch.core.faults import (
    FaultInjector,
    FaultPlan,
    FaultSpec,
    RecoveryConfig,
)
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import (
    Buffering,
    Management,
    Partitioning,
    TransferEngine,
    TransferPolicy,
    reassemble_chunks,
)
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.kernels._split import SPLIT_WORKSPACE
from repro_torch.kernels.conv2d.kernel import CONV2D, conv_plan, conv_ranges
from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import (
    conv2d_relu_ref,
    conv2d_split_ref,
    maxpool2,
)
from repro_torch.kernels.streamed_matmul.kernel import (
    MATMUL,
    TILES,
    matmul_blocks,
    matmul_unique,
    skinny,
    sm_count,
    split_k_plan,
    split_k_ranges,
    unique_one_block,
    unique_plan,
)
from repro_torch.kernels.decode_attention.kernel import (
    DECODE, MLA, mla_decode_bsd)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, mla_decode_ref)
from repro_torch.kernels.flash_attention.kernel import FLASH, SYMBOL
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_dkv_bshd)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_dkv,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.kernel import SSD
from repro_torch.kernels.ssd_scan.ops import (
    ssd_full,
    ssd_intra_chunk,
    ssd_state_pass,
)
from repro_torch.kernels.ssd_scan.ref import ssd_state_pass_ref
from repro_torch.kernels.streamed_matmul.ref import (
    matmul_blocks_split_ref,
    matmul_ref,
    matmul_unique_order_ref,
)
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers.attention import _cache_write
from repro_torch.models.layers.moe import moe_apply, moe_params
from repro_torch.models.layers.norm import apply_norm
from repro_torch.models.layers.ssm import ssd_chunked
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request
from repro_torch.serve.engine import ServeConfig, ServingEngine
from repro_torch.utils import trace

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


def _conv_case(dev, dtype, bsz, h, w, cin, cout, kh=3, kw=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((bsz, h, w, cin), generator=g).to(dev, dtype)
    wt = (torch.randn((kh, kw, cin, cout), generator=g) * 0.2).to(dev, dtype)
    b = (torch.randn((cout,), generator=g) * 0.1).to(dev, dtype)
    return x, wt, b


def _conv_checked(x, w, b, relu, tol):
    """One launch per call, two calls bitwise equal, within ``tol`` of the
    plain version and of the split-order plain version of the plan."""
    bsz, h, wd, cin = x.shape
    kh, kw, _, cout = w.shape
    before = CONV2D.launches["conv2d_bias_act"]
    got = conv2d_relu(x, w, b, relu=relu)
    again = conv2d_relu(x, w, b, relu=relu)
    assert CONV2D.launches["conv2d_bias_act"] == before + 2
    assert torch.equal(got, again)  # no float atomics: bitwise equal
    _, splits, per = conv_plan(bsz, h, wd, cin, cout, kh, kw,
                               sm_count(torch.cuda.current_device()))
    split = conv2d_split_ref(x, w, b, conv_ranges(kh, kw, cin, splits, per),
                             relu=relu)
    for ref in (conv2d_relu_ref(x, w, b, relu=relu), split):
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    # the last block of each split tile leaves its counter at 0
    for _part, cnt in SPLIT_WORKSPACE._bufs.values():
        assert int(cnt.abs().sum()) == 0
    return splits


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bsz", [1, 2, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hw,cin,cout", ROSHAMBO)
def test_conv2d_kernel_matches_plain(dev, hw, cin, cout, dtype, tol, bsz,
                                     relu):
    x, w, b = _conv_case(dev, dtype, bsz, hw, hw, cin, cout, seed=hw + cin)
    splits = _conv_checked(x, w, b, relu, tol)
    # batch 1 splits K over the SMs from conv2 on (conv1's K = 9 is one
    # chunk); a grid that fills the card takes one split
    tiles = -(-bsz * hw * hw // 64) * -(-cout // 32)
    chunks = -(-9 * cin // 32)
    assert (splits > 1) == (2 * tiles <= sm_count(
        torch.cuda.current_device()) and chunks > 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bsz,h,w,cin,cout,kh,kw", [
    (2, 7, 9, 3, 5, 3, 3),     # ragged tiles, element loads
    (1, 5, 6, 4, 7, 5, 3),     # a 5 x 3 kernel, split K
    (3, 11, 13, 24, 40, 3, 3),  # 16-byte copies in f32, not in bf16
])
def test_conv2d_kernel_ragged_shapes(dev, bsz, h, w, cin, cout, kh, kw,
                                     dtype, tol):
    x, wt, b = _conv_case(dev, dtype, bsz, h, w, cin, cout, kh, kw, seed=7)
    for relu in (True, False):
        _conv_checked(x, wt, b, relu, tol)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bsz", [1, 32])
@pytest.mark.parametrize("h,w,cin,cout,pool", [
    *[(hw, hw, cin, cout, i < 4) for i, (hw, cin, cout) in
      enumerate(ROSHAMBO)],  # the layers: conv1-4 pool, conv5 does not
    (7, 9, 3, 5, True),      # odd H and W: the last row and column dropped
    (11, 13, 24, 40, True),  # the same with 16-byte copies in f32
])
def test_conv2d_pooled_counted_launch(dev, h, w, cin, cout, pool, bsz, dtype,
                                      tol, relu):
    """The pooled and counted epilogue: one launch, bitwise the max pool of
    the unpooled launch (the same plan, so the same sums), its nonzeros
    added to the buffer's element it is given a view of, two calls equal in
    bytes and counts, within
    ``tol`` of the pool of the split-order plain version, and one
    ``conv.pool_fused`` where it pools."""
    x, wt, b = _conv_case(dev, dtype, bsz, h, w, cin, cout, seed=h + cin)
    counts = torch.zeros(3, dtype=torch.int32, device=dev)
    before = CONV2D.launches["conv2d_bias_act"]
    trace.enabled()  # the profiler below starts a fresh tracer session
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.count("test.session")  # the session's first record
        got = conv2d_relu(x, wt, b, relu=relu, pool=pool, counts=counts[1])
    assert CONV2D.launches["conv2d_bias_act"] == before + 1
    assert trace.counters().get("conv.pool_fused", 0) == int(pool)
    full = conv2d_relu(x, wt, b, relu=relu)
    want = maxpool2(full) if pool else full
    assert got.shape == want.shape and torch.equal(got, want)
    assert counts.tolist() == [0, int(torch.count_nonzero(want)), 0]
    again_counts = torch.zeros_like(counts)
    again = conv2d_relu(x, wt, b, relu=relu, pool=pool,
                        counts=again_counts[1])
    assert torch.equal(again, got) and torch.equal(again_counts, counts)
    _, splits, per = conv_plan(bsz, h, w, cin, cout, 3, 3,
                               sm_count(torch.cuda.current_device()))
    split = conv2d_split_ref(x, wt, b, conv_ranges(3, 3, cin, splits, per),
                             relu=relu)
    torch.testing.assert_close(
        got.float(), (maxpool2(split) if pool else split).float(), rtol=tol,
        atol=tol)
    for _part, cnt in SPLIT_WORKSPACE._bufs.values():
        assert int(cnt.abs().sum()) == 0


def test_conv2d_survives_scratch_growth_by_another_thread(dev, monkeypatch):
    """Between two conv launches on one stream, and between a launch's
    scratch lookup and its launch, a second thread grows the split-K
    workspace of that stream and a tensor of the old scratch's size is
    allocated. Each call holds its own scratch, so its partials land
    there: both results match, and the other tensor keeps its fill."""
    x, w, b = _conv_case(dev, torch.float32, 1, 4, 4, 128, 128, seed=3)
    ref = conv2d_relu_ref(x, w, b)
    scratch = SPLIT_WORKSPACE.scratch
    decoys = []

    def grown_meanwhile(device, stream, n_part, n_tiles):
        part, cnt = scratch(device, stream, n_part, n_tiles)
        t = threading.Thread(target=scratch, args=(
            device, stream, 4 * part.numel(), 4 * cnt.numel()))
        t.start()
        t.join()
        decoys.append(torch.full_like(part, float("nan")))
        return part, cnt

    monkeypatch.setattr(SPLIT_WORKSPACE, "scratch", grown_meanwhile)
    first = conv2d_relu(x, w, b)
    second = conv2d_relu(x, w, b)
    torch.cuda.synchronize()
    assert len(decoys) == 2, "the calls took no split-K scratch"
    for got in (first, second):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(first, second)
    assert all(bool(d.isnan().all()) for d in decoys)


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


# (m, k, n, tile): split K with K a multiple of bk and not, M = 1 (the
# classifier head, skinny), a grid that fills the card (one split), bf16
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,tile", [
    (1, 2048, 4, (32, 32, 16)),
    (1, 2050, 4, (32, 32, 16)),
    (3, 1000, 10, (64, 64, 32)),
    (100, 777, 33, (32, 32, 16)),
    (256, 3000, 256, (128, 128, 32)),
    (512, 300, 1024, (32, 32, 16)),
])
def test_matmul_blocks_split_k_matches_plain(dev, m, k, n, tile, dtype):
    g = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=g).to(dev, dtype)
    w = torch.randn((k, n), generator=g).to(dev, dtype)
    sms = sm_count(torch.cuda.current_device())
    splits, per = split_k_plan(m, n, k, tile, sms)
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    assert (splits > 1) == (2 * tiles <= sms)
    bm, bn, bk = tile
    before = MATMUL.launches["matmul_blocks"]
    got = matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
    again = matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
    assert MATMUL.launches["matmul_blocks"] == before + 2
    assert torch.equal(got, again)  # no float atomics: bitwise equal
    # the last block of each output tile leaves its counter at 0
    for _part, cnt in SPLIT_WORKSPACE._bufs.values():
        assert int(cnt.abs().sum()) == 0
    rtol, atol = (2e-4, 2e-3) if dtype == torch.float32 else (2e-2, 2e-1)
    split = matmul_blocks_split_ref(x, w, split_k_ranges(k, bk, splits, per))
    torch.testing.assert_close(got, split, rtol=rtol, atol=atol)
    torch.testing.assert_close(got, matmul_ref(x, w), rtol=rtol, atol=atol)
    if m == 1:
        assert skinny(m, n, tile)


def test_matmul_blocks_survives_scratch_growth_by_another_thread(
        dev, monkeypatch):
    """Between a call's scratch lookup and its launch, a second thread grows
    the workspace of the same stream and a tensor of the old scratch's size
    is allocated. The call still holds its own scratch, so the kernel's
    partials land there: the result matches, and the other tensor keeps
    its fill."""
    m, k, n, tile = 1, 2048, 4, (32, 32, 16)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((m, k), generator=g).to(dev)
    w = torch.randn((k, n), generator=g).to(dev)
    scratch = SPLIT_WORKSPACE.scratch
    decoys = []

    def grown_meanwhile(device, stream, n_part, n_tiles):
        part, cnt = scratch(device, stream, n_part, n_tiles)
        t = threading.Thread(target=scratch, args=(
            device, stream, 4 * part.numel(), 4 * cnt.numel()))
        t.start()
        t.join()
        decoys.append(torch.full_like(part, float("nan")))
        return part, cnt

    monkeypatch.setattr(SPLIT_WORKSPACE, "scratch", grown_meanwhile)
    bm, bn, bk = tile
    got = matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    assert decoys, "the call took no split-K scratch"
    torch.testing.assert_close(got, matmul_ref(x, w), rtol=2e-4, atol=2e-3)
    assert bool(decoys[0].isnan().all())


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
        trace.enabled()  # a fresh tracer session with the profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            res = ex.run_frame(params, frame)
    finally:
        ex.close()
    assert CONV2D.launches["conv2d_bias_act"] == before + 5
    counters = trace.counters()
    assert counters.get("conv.pool_fused") == 4  # conv1-4 pool in the kernel
    assert counters.get("wait.sparsity") == 1
    np.testing.assert_allclose(res.logits, ref, rtol=1e-4, atol=1e-4)
    # the sparsity the epilogue counted is, float for float, that of the
    # unpooled launches' fmaps pooled by maxpool2
    x = torch.from_numpy(frame).to(dev)
    want = []
    for spec in cnn.cfg.layers:
        x = cnn.layer_apply(spec, params[spec.name], x, conv=conv2d_relu)
        want.append(1.0 - int(torch.count_nonzero(x)) / x.numel())
    assert res.sparsity == want


def test_matmul_unique_grid_path_matches_plain(dev):
    # over one block's shared memory, within the 96 MiB UNIQUE budget
    g = torch.Generator().manual_seed(1)
    x = torch.randn((256, 384), generator=g).to(dev)
    w = torch.randn((384, 512), generator=g).to(dev)
    torch.testing.assert_close(matmul_unique(x, w), matmul_ref(x, w),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,offset", [
    (1, 2048, 4, 0),     # the classifier head: one micro-tile, 256 splits
    (100, 70, 33, 0),    # w's bytes not a 16-byte multiple: vector loads
    (100, 70, 33, 1),    # x and w one element off 16 bytes: scalar loads
    (128, 128, 128, 0),  # 1,024 micro-tiles of 4 x 4, four a thread
    (3, 5, 1, 0),        # M < 4: 1 x 4 micro-tiles, ragged columns
])
def test_matmul_unique_single_block_matches_plain(dev, m, k, n, offset,
                                                  dtype):
    g = torch.Generator().manual_seed(m + k)
    # an offset view: contiguous, but not on a 16-byte boundary
    xb = torch.randn((m * k + offset,), generator=g).to(dev, dtype)
    wb = torch.randn((k * n + offset,), generator=g).to(dev, dtype)
    x, w = xb[offset:].view(m, k), wb[offset:].view(k, n)
    assert unique_one_block(m, k, n, x.element_size())
    before = MATMUL.launches["matmul_unique"]
    got = matmul_unique(x, w)
    again = matmul_unique(x, w)
    assert MATMUL.launches["matmul_unique"] == before + 2
    assert torch.equal(got, again)  # a fixed reduction order
    rtol, atol = (2e-4, 2e-3) if dtype == torch.float32 else (2e-2, 2e-1)
    _, splits = unique_plan(m, n, k)
    for ref in (matmul_ref(x, w), matmul_unique_order_ref(x, w, splits)):
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


# f32: rtol = atol = 2e-4. bf16: rtol 2e-2 and an atol of 0.05 x the RMS
# of each plain output row, which scales with the row (chip_smoke.py's rule)
FLASH_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, None)}


# every head dim, causal / window / non-causal with Sq != Skv, GQA, and
# ragged S (not a multiple of the 128-row q tile or the 64-key K/V tile)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", [
    (2, 128, 128, 16, 2, 128, True, 0),
    (1, 512, 512, 8, 2, 80, True, 96),
    (2, 100, 250, 4, 2, 64, False, 0),
    (1, 333, 333, 4, 1, 160, True, 0),
    (1, 1000, 1000, 4, 4, 64, True, 96),
    (2, 77, 77, 4, 2, 80, True, 0),
    (1, 300, 190, 4, 1, 128, False, 0),
    (1, 1, 300, 2, 1, 64, False, 0),
    (1, 640, 640, 2, 1, 160, False, 200),
    (2, 257, 257, 8, 8, 128, True, 0),
    # the moe and vlm scoring shapes: granite-moe (D 64, 16/8 heads),
    # deepseek-moe (MHA, D 128), pixtral (256 prefix + 2048 text, 32/8)
    (2, 2048, 2048, 16, 8, 64, True, 0),
    (1, 2048, 2048, 16, 16, 128, True, 0),
    (1, 2304, 2304, 32, 8, 128, True, 0),
])
def test_flash_kernel_matches_plain(dev, b, sq, skv, h, hkv, d, causal,
                                    window, dtype):
    g = torch.Generator().manual_seed(sq + d)
    q = torch.randn((b, sq, h, d), generator=g).to(dev, dtype)
    k = torch.randn((b, skv, hkv, d), generator=g).to(dev, dtype)
    v = torch.randn((b, skv, hkv, d), generator=g).to(dev, dtype)
    before = dict(FLASH.launches)
    got = flash_attention(q, k, v, causal=causal, window=window)
    # bf16 on the tensor-core kernel, f32 on the CUDA-core one, once each
    assert {s: FLASH.launches[s] - before[s] for s in before} == {
        s: int(s == SYMBOL[dtype]) for s in before}
    assert got.dtype == dtype and got.shape == q.shape
    ref = flash_attention_plain(q, k, v, causal=causal, window=window).float()
    rtol, atol = FLASH_TOL[dtype]
    if atol is None:
        atol = 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + rtol * ref.abs()).all()), float(diff.max())


# MLA's decompressed prefill on the two-width entry: q / K 192 (128 + 64
# rope columns), V 128 a view into [k_nope | v] of 256, 16 heads; a 4,096-
# query chunk after 4,096 cached keys (dsv2lite.longdoc's second chunk), a
# ragged last chunk, and a batch of prompts alone
@pytest.mark.parametrize("b,sq,skv", [(1, 4096, 8192), (1, 777, 4873),
                                      (2, 300, 300)])
def test_flash_dkv_kernel_matches_plain(dev, b, sq, skv):
    """Within flash's bf16 rule of the plain version (scores f32, p in
    bf16), one launch of the two-width entry a call, repeats bitwise."""
    g = torch.Generator().manual_seed(sq + skv)
    q = torch.randn((b, sq, 16, 192), generator=g).to(dev, torch.bfloat16)
    k = torch.randn((b, skv, 16, 192), generator=g).to(dev, torch.bfloat16)
    v = torch.randn((b, skv, 16, 256), generator=g).to(
        dev, torch.bfloat16)[..., 128:]
    before = dict(FLASH.launches)
    got = flash_attention_dkv(q, k, v, q_offset=skv - sq)
    assert {s: FLASH.launches[s] - before[s] for s in before} == {
        s: int(s == "flash_attention_fwd_tc_dkv") for s in before}
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, 16, 128)
    ref = attention_ref(
        q.transpose(1, 2).reshape(b * 16, sq, 192),
        k.transpose(1, 2).reshape(b * 16, skv, 192),
        v.transpose(1, 2).reshape(b * 16, skv, 128),
        q_offset=skv - sq).reshape(b, 16, sq, 128).transpose(1, 2).float()
    atol = 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + 2e-2 * ref.abs()).all()), float(diff.max())
    assert torch.equal(got, flash_attention_dkv(q, k, v, q_offset=skv - sq))


def test_flash_dkv_kernel_raises_off_its_widths(dev):
    """The two-width entry is built for (192, 128) in bf16: the smoke
    config's widths, and f32, raise ``ValueError`` and launch nothing."""
    before = dict(FLASH.launches)
    for dk, dv, dt in ((24, 16, torch.bfloat16), (192, 128, torch.float32)):
        q = torch.zeros((1, 8, 4, dk), device=dev, dtype=dt)
        v = torch.zeros((1, 8, 4, dv), device=dev, dtype=dt)
        with pytest.raises(ValueError):
            flash_attention_dkv_bshd(q, q, v)
    assert dict(FLASH.launches) == before


@pytest.mark.parametrize("d,e,f,k,shared,renormalize", [
    (2048, 64, 1408, 6, 2, False),  # DeepSeek-V2-Lite
    (4096, 72, 768, 10, 2, True),  # granite-4.0-h-small: shared MLP 1,536
], ids=["deepseek-v2-lite", "granite-4.0-h-small"])
def test_ragged_moe_matches_the_padded_buffer_on_card(dev, d, e, f, k, shared,
                                                      renormalize):
    """A dropless MoE at a published model's widths on a 4,096-token chunk
    in bf16: each expert over its own seats gives the padded buffer's
    output within 1% of each row's RMS (the same bf16 products in GEMMs of
    other shapes round differently; a wrong or missing seat moves a row by
    tens of percent), and the grouped route never waits on the host (no
    call under ``set_sync_debug_mode("error")`` raises; its counters say
    the checked call took it)."""
    from repro_torch.models.layers import moe
    from repro_torch.utils import trace

    g = torch.Generator(dev).manual_seed(11)
    p = moe.moe_params(g, d, e, f, shared, torch.bfloat16, dev)
    x = torch.randn((1, 4096, d), generator=g, device=dev).to(
        torch.bfloat16)
    kw = dict(top_k=k, capacity_factor=e / k, renormalize=renormalize)
    with torch.no_grad():
        want, _ = moe.moe_apply(p, x, **kw)
        moe.moe_apply(p, x, ragged_tokens=256, **kw)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with trace.tally() as counts:
                got, _ = moe.moe_apply(p, x, ragged_tokens=256, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert counts == {"moe.rows": k * 4096, "moe.seats": k * 4096}
    want, got = want.float(), got.float()
    err = (got - want).pow(2).mean(-1).sqrt() / want.pow(2).mean(-1).sqrt()
    assert bool((err <= 0.01).all()), float(err.max())


def _small_lm(**over):
    # head dim 64, one the kernel is built for (the smoke config's is 16)
    cfg = smoke_config("qwen2.5-3b").replace(
        d_model=256, n_heads=4, n_kv_heads=2, dtype="float32", **over)
    return cfg, build_model(cfg)


def test_lm_forward_through_flash_matches_plain(dev):
    """f32 through the CUDA-core kernel, within 1e-4 of plain attention;
    bf16 through the tensor-core kernel, within flash's bf16 rule (2e-2
    |ref| + 0.05 RMS of the logits row) of the plain bf16 forward."""
    cfg, plain = _small_lm()
    params = plain.init(torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96))).to(dev)
    for dtype in ("float32", "bfloat16"):
        flash = build_model(cfg.replace(dtype=dtype,
                                        use_pallas_attention=True))
        plain = build_model(cfg.replace(dtype=dtype))
        ps = (params if dtype == "float32"
              else _cast_weights(params, torch.bfloat16))
        sym = SYMBOL[getattr(torch, dtype)]
        before = dict(FLASH.launches)
        lf, _ = flash.forward(ps, {"tokens": toks})
        assert {s: FLASH.launches[s] - before[s] for s in before} == {
            s: cfg.n_layers * (s == sym) for s in before}
        lp, _ = plain.forward(ps, {"tokens": toks})
        if dtype == "float32":
            torch.testing.assert_close(lf, lp, rtol=0, atol=1e-4)
        else:
            lf, lp = lf.float(), lp.float()
            atol = 0.05 * lp.pow(2).mean(-1, keepdim=True).sqrt()
            diff = (lf - lp).abs()
            assert torch.isfinite(lf).all()
            assert bool((diff <= atol + 2e-2 * lp.abs()).all()), float(
                diff.max())


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


# SSD, kernel against plain: f32 at the reference's 1e-3 (ssd_full against
# ssd_chunked, tests/test_kernels.py); bf16 rtol 2e-2 and an atol of 0.05 x
# the RMS of each plain output row (y_diag over P, states over N), as flash
SSD_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (2e-2, None)}


def _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed, strided=False):
    """The model's distributions: dt = softplus(randn + dt_bias), A from
    -1 to -16 over the heads, B and C scaled so C.B is ~unit. ``strided``
    cuts x, B and C out of one [B, S, H*P + 2*G*N] tensor, as the model's
    projection split does."""
    gen = torch.Generator().manual_seed(seed)
    xbc = torch.randn((b, s, h * p + 2 * g * n), generator=gen)
    xbc[..., h * p:] *= n ** -0.25
    xbc = xbc.to(dev, dtype)
    if not strided:
        xbc = xbc.contiguous()
    x = xbc[..., :h * p].reshape(b, s, h, p)
    bb = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cc = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    if not strided:
        x, bb, cc = x.contiguous(), bb.contiguous(), cc.contiguous()
    dt = F.softplus(torch.randn((b, s, h), generator=gen)
                    + math.log(math.e - 1)).to(dev)
    a = -torch.linspace(1.0, 16.0, h).to(dev)
    return x, dt, a, bb, cc


def _ssd_close(got, ref, dtype, row_dim=-1):
    rtol, atol = SSD_TOL[dtype]
    ref = ref.float()
    if atol is None:
        atol = 0.05 * ref.pow(2).mean(row_dim, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + rtol * ref.abs()).all()), float(diff.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,strided", [
    (2, 64, 4, 16, 2, 8, 8, False),
    (2, 64, 4, 16, 2, 8, 32, False),
    (1, 48, 2, 16, 1, 16, 16, True),
    (2, 128, 8, 64, 1, 64, 32, True),
    (1, 512, 8, 64, 1, 128, 256, True),
    (1, 256, 4, 64, 2, 16, 256, False),
])
def test_ssd_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, strided,
                                  dtype):
    args = _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=s + n,
                       strided=strided)
    before = SSD.launches["ssd_intra_chunk"]
    got = ssd_intra_chunk(*args, chunk=chunk)
    assert SSD.launches["ssd_intra_chunk"] == before + 1
    ref = ssd_intra_chunk(*args, chunk=chunk, use_kernel=False)
    for gt, rt in zip(got, ref):
        assert gt.dtype == torch.float32 and gt.shape == rt.shape
    _ssd_close(got[0], ref[0], dtype)
    _ssd_close(got[1], ref[1], dtype)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("chunk,p,n", list(itertools.product(
    ssd_kernel.CHUNKS, ssd_kernel.HEAD_DIMS, ssd_kernel.STATE_DIMS)))
def test_ssd_kernel_build_set_matches_plain(dev, monkeypatch, chunk, p, n,
                                            strided, dtype):
    """Every (Q, P, N) the kernel is built for, contiguous and strided, two
    groups of 4 heads; with no blocks-an-SM target the bf16 kernel takes
    the largest slice (4 heads a block), so C.B is shared across heads."""
    monkeypatch.setattr(ssd_kernel, "BLOCKS_PER_SM", 0)
    b, s, h, g = 2, 2 * chunk, 8, 2
    assert ssd_kernel.ssd_slice(b, s // chunk, h, g, chunk, 132) == 4
    args = _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=chunk + p + n,
                       strided=strided)
    before = dict(SSD.launches)
    got = ssd_intra_chunk(*args, chunk=chunk)
    assert {k: SSD.launches[k] - before[k] for k in before} == {
        "ssd_intra_chunk": 1, "ssd_state_pass": 0}
    ref = ssd_intra_chunk(*args, chunk=chunk, use_kernel=False)
    for gt, rt in zip(got, ref):
        assert gt.dtype == torch.float32 and gt.shape == rt.shape
    _ssd_close(got[0], ref[0], dtype)
    _ssd_close(got[1], ref[1], dtype)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("chunk", [32, 256])
def test_ssd_kernel_odd_head_slice_matches_plain(dev, monkeypatch, chunk):
    """Three heads a block (two groups of 3): the block's halves take 2 and
    1 heads of the slice."""
    monkeypatch.setattr(ssd_kernel, "BLOCKS_PER_SM", 0)
    b, s, h, p, g, n = 2, 2 * chunk, 6, 64, 2, 128
    assert ssd_kernel.ssd_slice(b, s // chunk, h, g, chunk, 132) == 3
    args = _ssd_inputs(dev, torch.bfloat16, b, s, h, p, g, n, seed=chunk,
                       strided=True)
    got = ssd_intra_chunk(*args, chunk=chunk)
    ref = ssd_intra_chunk(*args, chunk=chunk, use_kernel=False)
    _ssd_close(got[0], ref[0], torch.bfloat16)
    _ssd_close(got[1], ref[1], torch.bfloat16)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_state_pass_is_bitwise_the_loop(dev, with_state):
    """The state pass against its plain version (the torch loop) on the
    card: bitwise equal, one launch a call; through ssd_full, one launch of
    each SSD kernel a call."""
    gen = torch.Generator().manual_seed(5)
    bs, nc, h, p, n = 2, 8, 48, 64, 128
    states = torch.randn((bs, nc, h, p, n), generator=gen).to(dev)
    decay = torch.rand((bs, nc, h), generator=gen).to(dev)
    init = (torch.randn((bs, h, p, n), generator=gen).to(dev)
            if with_state else None)
    before = dict(SSD.launches)
    prev, final = ssd_state_pass(states, decay, init)
    assert {k: SSD.launches[k] - before[k] for k in before} == {
        "ssd_intra_chunk": 0, "ssd_state_pass": 1}
    wprev, wfinal = ssd_state_pass_ref(states, decay, init)
    assert torch.equal(prev, wprev) and torch.equal(final, wfinal)
    x, dt, a, bb, cc = _ssd_inputs(dev, torch.bfloat16, 2, 512, 8, 64, 1,
                                   128, seed=6, strided=True)
    init = (torch.randn((2, 8, 64, 128), generator=gen).to(dev)
            if with_state else None)
    before = dict(SSD.launches)
    y1, f1 = ssd_full(x, dt, a, bb, cc, chunk=256, initial_state=init)
    assert {k: SSD.launches[k] - before[k] for k in before} == {
        "ssd_intra_chunk": 1, "ssd_state_pass": 1}
    # the plain state pass on the kernel's own intra-chunk outputs
    _, st, dec = ssd_intra_chunk(x, dt, a, bb, cc, chunk=256)
    wfinal = ssd_state_pass_ref(st, dec, init)[1]
    assert torch.equal(f1, wfinal)


def test_logits_head_bf16_on_card_matches_the_up_cast_product(dev):
    """qwen2.5-3b's smoke config in bf16: the head's bf16-in, f32-out
    product within 1e-4 (rtol and atol: exact products, f32 sums in
    another order) of the up-cast f32 product on the same hidden states,
    under either setting of allow_bf16_reduced_precision_reduction (which
    must not reach an f32 output), with the same greedy argmax."""
    cfg = smoke_config("qwen2.5-3b").replace(dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 48))).to(dev)
    seen = []
    real = lm.logits_from_hidden

    def record(c, p, x):
        seen.append(x)
        return real(c, p, x)

    try:
        lm.logits_from_hidden = record
        logits, _ = model.forward(params, {"tokens": toks})
    finally:
        lm.logits_from_hidden = real
    (x,) = seen
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    assert x.dtype == head.dtype == torch.bfloat16
    up = torch.matmul(apply_norm(cfg.norm, params["final_norm"], x).float(),
                      head.float())
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits, up, rtol=1e-4, atol=1e-4)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        for on in (True, False):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
            torch.testing.assert_close(lm.logits_from_hidden(cfg, params, x),
                                       up, rtol=1e-4, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    assert torch.equal(logits.argmax(-1), up.argmax(-1))


def test_ssd_kernel_refuses_what_it_is_not_built_for(dev):
    x, dt, a, bb, cc = _ssd_inputs(dev, torch.float32, 1, 48, 2, 16, 1, 16, 0)
    with pytest.raises(ValueError, match="divisible"):
        ssd_intra_chunk(x, dt, a, bb, cc, chunk=32)
    with pytest.raises(ValueError, match="built for"):
        ssd_intra_chunk(x, dt, a, bb, cc, chunk=24)
    with pytest.raises(ValueError, match="float32"):
        ssd_intra_chunk(x, dt.bfloat16(), a, bb, cc, chunk=16)
    # the bf16 kernel copies 16-byte pieces: an x 2 bytes off is refused
    xb = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                     device=dev)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ssd_intra_chunk(xb, dt, a, bb.bfloat16(), cc.bfloat16(), chunk=16)


def test_ssd_full_kernel_matches_ssd_chunked(dev):
    x, dt, a, bb, cc = _ssd_inputs(dev, torch.float32, 2, 512, 8, 64, 1,
                                   128, seed=3)
    init = torch.randn((2, 8, 64, 128), generator=torch.Generator()
                       .manual_seed(4)).to(dev)
    y1, f1 = ssd_full(x, dt, a, bb, cc, chunk=256, initial_state=init)
    y2, f2 = ssd_chunked(x, dt, a, bb, cc, chunk=256, initial_state=init,
                         return_final_state=True)
    torch.testing.assert_close(y1, y2, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(f1, f2, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_models_through_the_ssd_kernel(dev, arch):
    """The smoke configs (P 16, N 16, Q 16) on the card: one SSD launch a
    mamba layer in a forward; the f32 logits match the same model run on
    the CPU (plain SSD); prefill (kernel) matches decode (recurrence)."""
    cfg = smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40))).to(dev)
    before = SSD.launches["ssd_intra_chunk"]
    logits, _ = model.forward(params, {"tokens": toks})
    assert SSD.launches["ssd_intra_chunk"] == before + cfg.n_layers
    cpu_params = _tree_to(params, "cpu")
    ref, _ = model.forward(cpu_params, {"tokens": toks.cpu()})
    torch.testing.assert_close(logits.cpu(), ref, rtol=0, atol=1e-3)
    last, _ = model.prefill(params, {"tokens": toks}, 48)
    cache = model.init_cache(2, 48, device=dev)
    before = SSD.launches["ssd_intra_chunk"]
    for t in range(toks.shape[1]):
        step, cache = model.decode(params, toks[:, t:t + 1], cache)
    assert SSD.launches["ssd_intra_chunk"] == before
    torch.testing.assert_close(step, last, rtol=0, atol=1e-3)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _cast_weights(tree, dtype):
    """The weights in ``dtype``; the norm params stay f32, as the
    reference keeps them in every dtype (chip_smoke.py's cast)."""
    if isinstance(tree, list):
        return [_cast_weights(v, dtype) for v in tree]
    return {k: v if k in ("ln1", "ln2", "final_norm")
            else _cast_weights(v, dtype) if isinstance(v, (dict, list))
            else v.to(dtype) for k, v in tree.items()}


def test_ssm_serving_on_card_is_policy_independent(dev):
    cfg = smoke_config("mamba2-780m").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 21),
                                                dtype=np.int32)
    got = []
    for policy in (TransferPolicy.kernel_level(),
                   TransferPolicy.user_level_polling()):
        eng = ServingEngine(model, params, ServeConfig(max_seq=48),
                            policy=policy)
        try:
            got.append(np.stack([r.tokens for r in eng.generate(prompts, 12)]))
        finally:
            eng.close()
    np.testing.assert_array_equal(got[0], got[1])


# ---- channel groups ---------------------------------------------------------

def _ring(**kw):
    return TransferPolicy.kernel_level_ring(4, block_bytes=1 << 20, **kw)


@pytest.mark.parametrize("form", ["rx", "rx_sg"])
def test_channels_striped_rx_waits_for_the_callers_stream(dev, form):
    """The tensors are written by a long kernel on a side stream the caller
    made current; the stripes are issued from joiner threads. Each member's
    copy stream must wait for the caller's stream, or a stripe is read
    before the kernel has written it."""
    g = ChannelGroup(_ring(), n_channels=2)
    want = [torch.full((1 << 18,), float(i + 1), device=dev)
            for i in range(8)]  # 8 x 1 MiB: striped over both channels
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    try:
        with torch.cuda.stream(side):
            ys = [torch.zeros_like(w) for w in want]
            torch.cuda._sleep(200_000_000)  # ~0.1 s on the side stream
            for y, w in zip(ys, want):
                y.copy_(w)
            if form == "rx":
                back = g.rx(ys)
            else:
                back = g.rx_sg(ys).wait(30.0)
        for b, w in zip(back, want):
            np.testing.assert_array_equal(np.asarray(b), w.cpu().numpy())
        assert all(e.rx_bytes_total > 0 for e in g.engines)
    finally:
        g.close()


def test_channels_pool_stages_from_pinned_memory(dev):
    g = ChannelGroup(_ring(), n_channels=2)
    try:
        assert g.device.type == "cuda" and g.staging_pool.pin_memory
        a = [np.arange(1 << 20, dtype=np.float32)]
        lay = g.layouts.get("k", a)
        assert torch.from_numpy(lay.staging).is_pinned()
        (got,) = lay.unpack(g.tx_async(lay.pack(a), layout=lay).wait())
        np.testing.assert_array_equal(got.cpu().numpy(), a[0])
        # a shape change recycles the pinned buffer through the pool
        lay2 = g.layouts.get("k", [np.zeros((1 << 20) - 5, np.float32)])
        assert lay2 is not lay and torch.from_numpy(lay2.staging).is_pinned()
        assert (g.staging_pool.allocations, g.staging_pool.reuses) == (1, 1)
    finally:
        g.close()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_channels_48mib_round_trip(dev, n):
    """The reference's per-layer payload, 48 MiB of f32, TX from pinned
    staging then RX into one pinned flat buffer: bitwise, every channel
    carrying a share."""
    x = np.random.default_rng(n).standard_normal(12 << 20).astype(
        np.float32)
    g = ChannelGroup(_ring(), n_channels=n)
    try:
        lay = g.layouts.get("x", [x])
        chunks = g.tx_async(lay.pack([x]), layout=lay).wait(60.0)
        assert all(c.is_cuda for c in chunks)
        assert torch.equal(reassemble_chunks(chunks).cpu(),  # the bytes
                           torch.from_numpy(x.view(np.uint8)))
        out = torch.empty(x.nbytes, dtype=torch.uint8,
                          pin_memory=True).numpy()
        g.rx(chunks, out=out)
        np.testing.assert_array_equal(out.view(np.float32), x)
        for direction in ("tx", "rx"):
            carried = [getattr(e, f"{direction}_bytes_total")
                       for e in g.engines]
            assert sum(carried) == x.nbytes and all(c > 0 for c in carried)
    finally:
        g.close()


def test_channels_calibration_on_card(dev):
    m = calibrate_transfer()
    assert math.isfinite(m.t0_s) and m.t0_s > 0
    assert 1e9 <= m.bw_Bps <= 100e9


def test_faults_corrupt_drop_and_stall_recover_on_card(dev):
    """A dropped TX stripe and a corrupted RX stripe retry on a sibling; a
    stalled channel is pulled from the rotation and rejoins once the stall
    lifts and a probe runs at a healthy rate. The bytes stay exact."""
    inj = FaultInjector(FaultPlan(seed=0, specs=(
        FaultSpec(kind="drop", p=1.0, channel=0, direction="tx",
                  hold_s=0.0, max_injections=1),
        FaultSpec(kind="corrupt", p=1.0, channel=0, max_injections=1))))
    g = ChannelGroup(dataclasses.replace(_ring(), checksum=True),
                     n_channels=3, engine_factory=inj.engine_factory(),
                     recovery=RecoveryConfig(stripe_timeout_s=30.0,
                                             probe_interval_s=0.0))
    x = (np.arange(12 << 20) % 251).astype(np.uint8)

    def round_trip():
        chunks = g.tx(x)
        flat = np.concatenate([np.asarray(h).reshape(-1)
                               for h in g.rx(chunks)])
        np.testing.assert_array_equal(flat, x)

    try:
        round_trip()
        s = g.fault_state.summary()
        assert s["retries"] == s["retry_successes"] == 2
        assert s["checksum_failures"] == 1
        # The drift check quarantines the stalled channel when its
        # descriptors take drift_quarantine_ratio (4) times its siblings',
        # and a probe runs in the same pass: one 64 KiB descriptor on the
        # stalled channel, raced against the same descriptor on a sibling,
        # stays out only if it too took 4 times as long. Both read host
        # clocks: a sibling's descriptor takes ~1 ms on a quiet host and
        # a scheduler quantum or more on a loaded one, so a fixed 20 ms
        # stall let a slow host rejoin the channel at once. The stall is
        # set from the healthy time measured here, 20 times the slowest
        # of 8 healthy probes, and at least 100 ms (several quanta).
        probe = np.zeros(g.recovery.probe_bytes, np.uint8)
        healthy = []
        for _ in range(8):
            t0 = time.perf_counter()
            g.engines[0].tx_async(probe).wait(30.0)
            healthy.append(time.perf_counter() - t0)
        stall_s = max(0.1, 20 * max(healthy))
        inj.stall(1, on=True, stall_s=stall_s)
        for _ in range(8):
            g.tx(x)
            g.check_channel_health()
            if g.fault_state.summary()["quarantines"]:
                break
        s = g.fault_state.summary()
        assert g.quarantined == {1}, (
            f"quarantines {s['quarantines']}, unquarantines "
            f"{s['unquarantines']}; healthy probes {healthy} s, stall "
            f"{stall_s} s")
        round_trip()
        inj.stall(1, on=False)
        for _ in range(10):
            if g.check_channel_health():
                break
        assert g.quarantined == set()
        round_trip()
        s = g.fault_state.summary()
        assert (s["quarantines"], s["unquarantines"]) == (1, 1)
    finally:
        g.close()


@pytest.mark.parametrize("kw", [{"n_channels": 2},
                                {"adaptive_transfer": True},
                                {"online_adaptation": True}])
def test_channels_serving_settings_on_card(dev, kw):
    cfg, model = _small_lm()
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                                dtype=np.int32)
    got = []
    for scfg in (ServeConfig(max_seq=48), ServeConfig(max_seq=48, **kw)):
        eng = ServingEngine(model, params, scfg)
        try:
            assert eng.engine.device.type == "cuda"
            got.append(np.stack([r.tokens for r in eng.generate(prompts, 8)]))
            assert eng.fault_summary()["faults"]["faults"] == 0
        finally:
            eng.close()
    np.testing.assert_array_equal(got[0], got[1])


# ---- the concurrency hammers on the card ------------------------------------

@pytest.mark.parametrize("hammer", stress.HAMMERS, ids=lambda h: h.__name__)
def test_stress_hammer_on_card(dev, hammer):
    """The reference's five stress hammers (tests/test_torch_stress.py on the
    CPU) with card engines, under validated locks: their own checks, no
    lock-order violation."""
    with stress.validated_locks() as graph:
        got = hammer(stress.port_stack(dev))
        assert graph.violations == []
    assert got.transfers > 0 and got.bytes > 0


@pytest.mark.parametrize("case", stress.CONSUMER_CASES,
                         ids=lambda c: f"{c[0]}ch")
def test_stress_consumer_streams_on_card(dev, case):
    """8 threads, each on a side stream of its own, compute on a TX result,
    drop it before that kernel ran, TX their next payload and RX the
    product: every product bitwise the host's (F13: the TX result is
    handed over to the submitting thread's stream)."""
    with stress.validated_locks() as graph:
        got = stress.consumer_streams(stress.port_stack(dev), *case)
        assert graph.violations == []
    assert got.extra["mismatches"] == 0


# ---- continuous batching and the moe family ---------------------------------

def test_cache_write_drops_rows_past_the_end_on_card(dev):
    """Per-slot lengths past S_max: those rows are dropped, on the card as
    on the CPU, with no device-side assert (which would poison the
    context)."""
    g = torch.Generator().manual_seed(0)
    dst = torch.randn((3, 16, 2, 8), generator=g)
    new = torch.randn((3, 4, 2, 8), generator=g)
    length = torch.tensor([14, 16, 40], dtype=torch.int32)
    want = _cache_write(dst.clone(), new, length)
    got = _cache_write(dst.to(dev), new.to(dev), length.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[1:], dst[1:]) and not torch.equal(want, dst)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_smoke_on_card_matches_cpu(dev, arch):
    """One moe layer at the smoke shape, f32: the same number of dropped
    seats (the f32 mean that gives the fraction may round apart by an
    ulp) and outputs within 1e-5 of the CPU's."""
    cfg = smoke_config(arch)
    p = moe_params(torch.Generator().manual_seed(0), cfg.d_model,
                   cfg.n_experts, cfg.d_expert or cfg.d_ff,
                   cfg.n_shared_experts, torch.float32, "cpu")
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    for cf in (1.25, 0.5):
        want, wm = moe_apply(p, x, top_k=cfg.top_k, capacity_factor=cf)
        got, gm = moe_apply(_tree_to(p, dev), x.to(dev), top_k=cfg.top_k,
                            capacity_factor=cf)
        seats = x.shape[0] * x.shape[1] * cfg.top_k
        assert (round(float(gm.dropped_frac) * seats)
                == round(float(wm.dropped_frac) * seats))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5)
        torch.testing.assert_close(gm.aux_loss.cpu(), wm.aux_loss, rtol=0,
                                   atol=1e-6)


@contextlib.contextmanager
def _private_engine(model, params, **kw):
    """A continuous-batching engine on the params' device over a
    kernel-level transfer engine on a private runtime, whose admission
    reads no TOKEN deadline misses that earlier tests left on the shared
    runtime (F14); closes all three."""
    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(),
                              device=params["embed"].device, runtime=rt)
    eng = ContinuousBatchingEngine(model, params, transfer=transfer, **kw)
    try:
        yield eng
    finally:
        eng.close()
        transfer.close()
        rt.close()


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "granite-moe-1b-a400m"])
def test_continuous_engine_on_card_matches_cpu(dev, arch):
    """The smoke model's engine on the card gives the CPU engine's tokens,
    with slot 0 idle past max_seq while slot 1 decodes."""
    cfg = smoke_config(arch).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab, n).astype(np.int32), new)
            for n, new in ((14, 2), (4, 14), (9, 3))]
    got = {}
    for where in ("cpu", dev):
        with _private_engine(model, _tree_to(params, where), n_slots=2,
                             max_seq=20) as eng:
            assert eng.transfer.device.type == torch.device(where).type
            for i, (p, new) in enumerate(reqs):
                assert eng.submit(Request(rid=i, prompt=p,
                                          max_new_tokens=new)).admitted
            done = eng.run_to_completion()
            got[str(where)] = ([(r.rid, r.tokens) for r in done],
                               eng.cache.length.cpu().tolist())
    (cpu_toks, cpu_len), (card_toks, card_len) = got.values()
    assert card_toks == cpu_toks and card_len == cpu_len
    assert max(card_len) > 20


# ---- decode attention and the decode graph ----------------------------------

def _decode_lengths(b, s_max, median, seed):
    """[B] lengths like a served batch's: lognormal around ``median``, with
    an empty slot, a full one (S_max - 1 cached) and an idle slot past
    S_max."""
    rng = np.random.default_rng(seed)
    n = np.clip(np.rint(median * np.exp(0.6 * rng.standard_normal(b))), 0,
                s_max - 1).astype(np.int64)
    n[:3] = (0, s_max - 1, s_max + 50)
    return torch.from_numpy(n)


# granite.chat's decode (64 slots, 16 / 8 heads of 64, S_max 2,560, ~755
# live rows) and granite4h.rag's (32 / 8 heads of 128, S_max 4,608, ~2,000
# live rows); a group of 1 and of 8 at D 128; an int and a 0-d length; the
# cache as a layer of a stacked [L, B, S, Hkv, Dh] tensor
@pytest.mark.parametrize("b,s_max,h,hkv,dh,median,length,scale", [
    (64, 2560, 16, 8, 64, 755, "slots", None),
    (64, 4608, 32, 8, 128, 2000, "slots", 0.0078125),
    (8, 1000, 8, 8, 128, 300, "slots", None),
    (4, 700, 16, 2, 128, 500, "int", None),
    (3, 300, 4, 2, 64, 0, "0-d", 0.3),
])
def test_decode_attention_kernel_matches_plain(dev, b, s_max, h, hkv, dh,
                                               median, length, scale):
    """Within flash's bf16 rule (2e-2 |ref| + 0.05 RMS of the plain output
    row: the kernel rounds each p to bf16 against a running maximum, the
    plain version against the row's, and sums in another order), one
    launch a call, two calls bitwise equal."""
    g = torch.Generator().manual_seed(s_max + dh)
    q = torch.randn((b, 1, h, dh), generator=g).to(dev, torch.bfloat16)
    kv = torch.randn((2, 2, b, s_max, hkv, dh), generator=g).to(
        dev, torch.bfloat16)
    k, v = kv[0, 1], kv[1, 1]  # layer 1 of a stacked cache
    n = {"slots": _decode_lengths(b, s_max, median, s_max).to(dev),
         "int": s_max // 3, "0-d": torch.tensor(s_max + 9, device=dev)}[
        length]
    before = DECODE.launches["decode_attention"]
    got = decode_attention(q, k, v, n, scale=scale)
    assert DECODE.launches["decode_attention"] - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref = decode_attention_ref(q, k, v, n, scale=scale).float()
    atol = 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + 2e-2 * ref.abs()).all()), float(diff.max())
    assert torch.equal(got, decode_attention(q, k, v, n, scale=scale))


def _decode_lm(arch):
    """A smoke LM in bf16 whose attention heads are 64 wide (a head dim
    the decode kernel is built for; the smoke configs' is 16)."""
    cfg = smoke_config(arch).replace(dtype="bfloat16", head_dim=64)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-4.0-h-small"])
def test_decode_steps_take_the_kernel_on_card(dev, arch):
    """Decode steps through the model on the card launch the kernel once
    an attention layer a step, and give the CPU's logits within flash's
    bf16 rule (the CPU takes the plain route)."""
    cfg, model, params = _decode_lm(arch)
    n_attn = len(cfg.attn_layers) if cfg.layer_types else cfg.n_layers
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (3, 1)).astype(np.int32))
    out = {}
    for where in ("cpu", dev):
        ps = _tree_to(params, where)
        cache = model.init_cache(3, 40, device=where)
        cache = cache._replace(length=torch.tensor([0, 17, 39],
                                                   device=where))
        rows, before = [], DECODE.launches["decode_attention"]
        for _ in range(3):
            logits, cache = model.decode(ps, toks.to(where), cache)
            rows.append(logits.float().cpu())
        out[str(where)] = torch.stack(rows)
        if where != "cpu":
            assert DECODE.launches["decode_attention"] - before == 3 * n_attn
    want, got = out["cpu"], out[str(dev)]
    atol = 0.05 * want.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got - want).abs()
    assert bool((diff <= atol + 2e-2 * want.abs()).all()), float(diff.max())


def _snapshot(cache):
    return cache._replace(**{f: getattr(cache, f).clone()
                             for f in cache._fields})


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "granite-4.0-h-small"])
def test_graph_replayed_decode_is_bitwise_eager(dev, arch):
    """The engine's decode steps on the card, replayed from the graph it
    captures after its first step: each step's logits, cache tensors and
    length bitwise those of an eager decode of the same inputs, over
    every step of 5 requests on 3 slots (admissions splice into the
    graph's cache after the capture); a replay ticks
    ``serve.graph_replay`` once and ``attn.decode`` once an attention
    layer (the profiled step's eager twin ticks it as often again)."""
    cfg, model, params = _decode_lm(arch)
    n_attn = len(cfg.attn_layers) if cfg.layer_types else cfg.n_layers
    seen = []  # (graphed, logits equal, cache equal)

    def decode(ps, token, cache):
        graphed = isinstance(cache, lm.DecodeGraph)
        static = cache.cache if graphed else cache
        tok0, cache0 = token.clone(), _snapshot(static)
        logits, new = model.decode(ps, token, cache)
        want, want_cache = model.decode(ps, tok0, cache0)
        seen.append((graphed, torch.equal(logits, want), all(
            torch.equal(getattr(new, f), getattr(want_cache, f))
            for f in new._fields)))
        return logits, new

    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new_tokens=new) for i, (n, new) in enumerate(
            [(9, 5), (4, 7), (13, 4), (6, 6), (11, 3)])]
    with _private_engine(dataclasses.replace(model, decode=decode),
                         _tree_to(params, dev), n_slots=3,
                         max_seq=48) as eng:
        for r in reqs:
            assert eng.submit(r).admitted
        eng.step()
        assert isinstance(eng._graph, lm.DecodeGraph)
        eng.step()  # the capture
        trace.enabled()  # seen off: the profiled step's records start afresh
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.step()
            counts = trace.counters()
        done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == list(range(5))
    assert counts.get("serve.graph_replay") == 1
    assert counts.get("attn.decode") == 2 * n_attn
    assert [g for g, _, _ in seen] == [False] + [True] * (len(seen) - 1)
    assert len(seen) >= 8 and all(lg and c for _, lg, c in seen), seen


# dsv2lite.longdoc's decode (32 slots, S_max 18,432, ~9,500 live rows, the
# YaRN sigma), a small batch, an int and a 0-d length; the rows as a layer
# of a stacked [L, B, S, 576] cache
@pytest.mark.parametrize("b,s_max,median,length,scale", [
    (32, 18432, 9500, "slots", 0.11472138679292612),
    (8, 1000, 300, "slots", 0.0721),
    (4, 700, 0, "int", 0.1),
    (3, 300, 0, "0-d", 0.3),
])
def test_mla_decode_kernel_matches_plain(dev, b, s_max, median, length,
                                         scale):
    """Within flash's bf16 rule (2e-2 |ref| + 0.05 RMS of the plain output
    row: the kernel rounds each p to bf16 against a running maximum, the
    plain version against the row's, and sums in another order), one
    launch a call, two calls bitwise equal."""
    g = torch.Generator().manual_seed(s_max + b)
    q = torch.randn((b, 16, 576), generator=g).to(dev, torch.bfloat16)
    rows = torch.randn((2, b, s_max, 576), generator=g).to(
        dev, torch.bfloat16)[1]
    n = {"slots": _decode_lengths(b, s_max, median, s_max).to(dev),
         "int": s_max // 3, "0-d": torch.tensor(s_max + 9, device=dev)}[
        length]
    before = MLA.launches["mla_decode"]
    got = mla_decode_bsd(q, rows, n, scale=scale)
    assert MLA.launches["mla_decode"] - before == 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 16, 512)
    ref = mla_decode_ref(q, rows, n, scale=scale, value_dim=512).float()
    atol = 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    diff = (got.float() - ref).abs()
    assert torch.isfinite(got).all()
    assert bool((diff <= atol + 2e-2 * ref.abs()).all()), float(diff.max())
    assert torch.equal(got, mla_decode_bsd(q, rows, n, scale=scale))


def _mla_lm():
    """DeepSeek-V2-Lite's smoke LM in bf16 at the latent kernel's widths
    (16 heads, c of 512, k^R of 64, values of 128)."""
    cfg = smoke_config("deepseek-v2-lite").replace(
        dtype="bfloat16", n_heads=16, n_kv_heads=16, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def test_mla_decode_steps_take_the_kernel_on_card(dev):
    """Decode steps of the smoke DeepSeek-V2-Lite at the kernel's widths
    launch it once a layer a step, and give the CPU's logits (the CPU
    takes the plain version) within 5% of each row's RMS, in RMS over the
    row: the card's bf16 products and the kernel's rounding of p each move
    a row by up to ~2% after three layers and their MoE, where a wrong or
    missing latent row moves it by tens of percent."""
    cfg, model, params = _mla_lm()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (3, 1)).astype(np.int32))
    kv0 = torch.randn(model.init_cache(3, 40, device="cpu").kv.shape,
                      generator=torch.Generator().manual_seed(5))
    out = {}
    for where in ("cpu", dev):
        ps = _tree_to(params, where)
        cache = model.init_cache(3, 40, device=where)
        cache.kv.copy_(kv0)  # earlier tokens' rows
        cache = cache._replace(length=torch.tensor([0, 17, 39],
                                                   device=where))
        rows, before = [], MLA.launches["mla_decode"]
        for _ in range(3):
            logits, cache = model.decode(ps, toks.to(where), cache)
            rows.append(logits.float().cpu())
        out[str(where)] = torch.stack(rows)
        if where != "cpu":
            assert MLA.launches["mla_decode"] - before == 3 * cfg.n_layers
    want, got = out["cpu"], out[str(dev)]
    err = (got - want).pow(2).mean(-1).sqrt() / want.pow(2).mean(-1).sqrt()
    assert bool((err <= 0.05).all()), err


@pytest.mark.parametrize("widths", ["smoke", "float32"])
def test_mla_decode_off_the_kernel_raises_on_card(dev, widths):
    """On the card a decode step takes the latent kernel or raises: the
    smoke config's own widths (4 heads, c of 32), and f32 at the kernel's
    widths, raise ``ValueError`` rather than fall back to the plain
    version, which only CPU tensors take."""
    cfg = (smoke_config("deepseek-v2-lite").replace(dtype="bfloat16")
           if widths == "smoke" else _mla_lm()[0].replace(dtype="float32"))
    model = build_model(cfg)
    params = _tree_to(model.init(torch.Generator().manual_seed(0), "cpu"),
                      dev)
    cache = model.init_cache(2, 16, device=dev)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="latent kernel"):
        model.decode(params, tok, cache)

def test_graph_replayed_dsv2lite_decode_is_bitwise_eager(dev):
    """DeepSeek-V2-Lite at every published width (27 layers, 15.7B
    parameters in bf16) served on 32 slots: each decode step, replayed
    from the graph the engine captures after its first step, gives bitwise
    the logits, latent cache and length of an eager decode of the same
    inputs, over every step of 40 requests (admissions splice into the
    graph's cache after the capture); a replay ticks ``attn.decode_latent``
    once a layer (the profiled step's eager twin as often again) and
    ``attn.decode`` not at all."""
    cfg = get_config("deepseek-v2-lite")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    seen = []  # (graphed, logits equal, cache equal)

    def decode(ps, token, cache):
        graphed = isinstance(cache, lm.DecodeGraph)
        static = cache.cache if graphed else cache
        tok0, cache0 = token.clone(), _snapshot(static)
        logits, new = model.decode(ps, token, cache)
        want, want_cache = model.decode(ps, tok0, cache0)
        seen.append((graphed, torch.equal(logits, want), all(
            torch.equal(getattr(new, f), getattr(want_cache, f))
            for f in new._fields)))
        return logits, new

    rng = np.random.default_rng(6)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, int(n)).astype(
        np.int32), max_new_tokens=int(new)) for i, (n, new) in enumerate(
            zip(rng.integers(8, 40, 40), rng.integers(2, 8, 40)))]
    with _private_engine(dataclasses.replace(model, decode=decode), params,
                         n_slots=32, max_seq=64) as eng:
        for r in reqs:
            assert eng.submit(r).admitted
        eng.step()
        assert isinstance(eng._graph, lm.DecodeGraph)
        eng.step()  # the capture
        trace.enabled()  # seen off: the profiled step's records start afresh
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            eng.step()
            counts = trace.counters()
        done = eng.run_to_completion()
    assert sorted(r.rid for r in done) == list(range(40))
    assert counts.get("serve.graph_replay") == 1
    assert counts.get("attn.decode_latent") == 2 * cfg.n_layers
    assert not counts.get("attn.decode")
    assert counts.get("attn.latent_rows", 0) > 0
    assert [g for g, _, _ in seen] == [False] + [True] * (len(seen) - 1)
    assert len(seen) >= 8 and all(lg and c for _, lg, c in seen), seen


# ---- training (F8: gradients through the kernels) ---------------------------

def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
def test_ssd_gradients_through_the_kernels_match_the_plain_route(dev, dtype,
                                                                 tol):
    """F8: ``ssd_full`` under grad launches both kernels once and its
    gradients (the plain version's VJP, fed the kernel route's cotangent)
    match autograd through the plain route, relative L2 per input: f32
    the SSD's 1e-3, bf16 2e-2 (the final states differ by the kernels'
    bf16 rounding, and so does the cotangent the loss gives them)."""
    args = _ssd_inputs(dev, dtype, 2, 512, 8, 64, 1, 128, seed=5,
                       strided=True)
    init = torch.randn((2, 8, 64, 128), generator=torch.Generator()
                       .manual_seed(6)).to(dev)
    w = torch.randn(args[0].shape, generator=torch.Generator()
                    .manual_seed(7)).to(dev)
    grads = []
    for use_kernel in (True, False):
        ins = [t.detach().requires_grad_() for t in (*args, init)]
        before = dict(SSD.launches)
        y, st = ssd_full(*ins[:5], chunk=256, initial_state=ins[5],
                         use_kernel=use_kernel)
        if use_kernel:
            assert type(y.grad_fn).__name__ == "_SSDFullBackward"
        loss = (y.float() * w).mean() + st.square().mean()
        loss.backward()
        torch.cuda.synchronize()
        n = int(use_kernel)
        assert {k: SSD.launches[k] - before[k] for k in before} == {
            "ssd_intra_chunk": n, "ssd_state_pass": n}
        grads.append([t.grad for t in ins])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        assert _rel_l2(a, b) <= tol


def test_ssm_model_gradients_on_card_match_the_cpu(dev):
    """F8 at the model: the smoke mamba2's gradients on the card (the SSD
    through the kernels) against the same params' on the CPU (the plain
    SSD), every leaf within 1e-3 relative L2 (f32). Plain autograd, so
    the test runs on code without the port's training modules too (on
    code where the kernels' outputs carry no grad_fn, it fails)."""
    cfg = smoke_config("mamba2-780m").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}

    def grads(where):
        leaves = {}

        def handle(tree, path=()):
            if isinstance(tree, dict):
                return {k: handle(v, path + (k,)) for k, v in tree.items()}
            t = tree.detach().clone().to(where).requires_grad_()
            leaves[path] = t
            return t

        loss, _ = model.loss(handle(params), _tree_to(batch, where))
        loss.backward()
        return float(loss), {k: t.grad.cpu() for k, t in leaves.items()}

    before = SSD.launches["ssd_intra_chunk"]
    lc, gc = grads(dev)
    assert SSD.launches["ssd_intra_chunk"] == before + cfg.n_layers
    lh, gh = grads("cpu")
    assert lc == pytest.approx(lh, abs=1e-4)
    rel = {"/".join(k): _rel_l2(gc[k], gh[k]) for k in gh}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-3, (worst, rel[worst])


def test_kernels_refuse_a_gradient(dev):
    """Flash (and conv2d, the matmuls) have no backward: under grad with an
    input that requires grad they raise, where their outputs would
    otherwise carry no grad_fn and the gradients come back wrong."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 64, 4, 64), generator=g).to(dev, torch.bfloat16)
    k = torch.randn((1, 64, 2, 64), generator=g).to(dev, torch.bfloat16)
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        flash_attention(qg, k, k)
    with torch.no_grad():
        flash_attention(qg, k, k)
    flash_attention(q, k, k)  # nothing needs a gradient
    x, w, b = _conv_case(dev, torch.float32, 1, 8, 8, 4, 8)
    with pytest.raises(NotImplementedError, match="no backward"):
        conv2d_relu(x, w.requires_grad_(), b)
    a = torch.randn((4, 32), generator=g).to(dev).requires_grad_()
    m = torch.randn((32, 8), generator=g).to(dev)
    for fn in (matmul_unique, matmul_blocks):
        with pytest.raises(NotImplementedError, match="no backward"):
            fn(a, m)


def test_logits_head_bf16_backward_on_card(dev):
    """The bf16 head's backward (two bf16 products into f32, the
    cotangent rounded to bf16) against autograd through the up-cast f32
    product: relative L2 within 1e-2 (the cotangent's bf16 rounding,
    2^-9 an element), and the forward unchanged."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 48, 256), generator=g).to(dev, torch.bfloat16)
    head = (torch.randn((256, 1000), generator=g) * 0.06).to(
        dev, torch.bfloat16)
    w = torch.randn((2, 48, 1000), generator=g).to(dev)
    got, want = [], []
    for out, up in ((got, False), (want, True)):
        xs, hs = x.clone().requires_grad_(), head.clone().requires_grad_()
        y = (lm.head_product(xs, hs) if not up
             else torch.matmul(xs.float(), hs.float()))
        assert y.dtype == torch.float32
        (y * w).sum().backward()
        out += [y.detach(), xs.grad, hs.grad]
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.bfloat16
        assert _rel_l2(a, b) <= 1e-2


def test_adamw_step_on_card_matches_cpu(dev):
    """One AdamW step (clip, bias correction, decay on matrices) on the
    card against the CPU's, f32, 1e-6."""
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    g = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((3, 64, 32), generator=g),
         "b": torch.randn((32,), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) * 3 for k, v in p.items()}
    out = {}
    for where in ("cpu", dev):
        pp = {k: v.clone().to(where) for k, v in p.items()}  # updated in place
        st = adamw_init(pp)
        adamw_update(AdamWConfig(lr=1e-2), _tree_to(grads, where), st, pp,
                     torch.tensor(0.5, device=where))
        adamw_update(AdamWConfig(lr=1e-2), _tree_to(grads, where), st, pp,
                     torch.tensor(1.0, device=where))
        out[str(where)] = (pp, st)
    (cp, cs), (gp, gs) = out.values()
    for k in p:
        torch.testing.assert_close(gp[k].cpu(), cp[k], rtol=1e-6, atol=1e-6)
        for part in ("m", "v", "master"):
            torch.testing.assert_close(gs[part][k].cpu(), cs[part][k],
                                       rtol=1e-6, atol=1e-6)
    assert int(gs["step"]) == 2 and gs["step"].device.type == "cuda"


@pytest.mark.parametrize("policy", ["user_level_polling",
                                    "user_level_scheduled", "kernel_level"])
@pytest.mark.parametrize("transport", ["engine", "copy_stream"])
def test_staged_batches_on_card_are_the_host_batches(dev, policy, transport):
    """20 batches staged on the card (through an engine, or the pipeline's
    own copy stream), each read by a kernel on the consumer's stream
    right away and again after the next batch staged: bitwise the host
    batches (a wrong wait would read a half-copied batch, a missing
    record_stream a reused one)."""
    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    cfg = smoke_config("pixtral-12b")
    src = SyntheticLMSource(DataConfig(4, cfg.n_prefix_tokens + 64, 3), cfg)
    eng = (TransferEngine(TransferPolicy.kernel_level(), device=dev)
           if transport == "engine" else None)
    pipe = StagedPipeline(src, getattr(TransferPolicy, policy)(),
                          engine=eng, device=dev)
    prev = None
    try:
        for i in range(20):
            batch = next(pipe)
            want = src.next_host_batch(i)
            for k, v in want.items():
                assert batch[k].device.type == "cuda"
                assert torch.equal(batch[k], torch.from_numpy(v).to(dev))
            if prev is not None:  # the last batch, read after this one
                for k, v in prev[1].items():
                    np.testing.assert_array_equal(prev[0][k].cpu().numpy(),
                                                  v)
            prev = (batch, want)
    finally:
        pipe.close()
        if eng is not None:
            eng.close()


def test_checkpoint_mid_training_holds_the_params_of_its_step(dev, tmp_path):
    """A Trainer on the card saves asynchronously at step 2 and updates the
    params in place in the steps after: the file holds the params and the
    optimizer state as they were at step 2, exactly."""
    from repro_torch.checkpoint import restore_latest
    from repro_torch.checkpoint.checkpoint import _unflatten_into
    from repro_torch.optim import adamw_init
    from repro_torch.train.loop import TrainConfig, Trainer
    from repro_torch.utils.pytree import tree_leaves, tree_map
    cfg = smoke_config("qwen2.5-3b").replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(params)
    rng = np.random.default_rng(0)
    seen = {}

    def batches():
        for i in range(4):
            if i == 2:  # maybe_save(2) ran after step 1
                seen["at2"] = tree_map(lambda t: t.detach().cpu().clone(),
                                       {"params": params, "opt": opt})
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 33))).to(dev)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    t = Trainer(model, TrainConfig(steps=4, warmup=1,
                                   checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2))
    t.run(batches(), initial_state=(params, opt))
    assert restore_latest(str(tmp_path), seen["at2"])[0] == 4
    with np.load(tmp_path / "step-00000002.npz") as z:
        tree = _unflatten_into(seen["at2"], {k: z[k] for k in z.files})
    for a, b in zip(tree_leaves(tree), tree_leaves(seen["at2"])):
        assert torch.equal(a, b)
    moved = [not torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(params), tree_leaves(seen["at2"]["params"]))]
    assert any(moved)


# --------------------------------------------------------------------------
# the distributed slice on the card: a world of one NCCL rank (NCCL takes
# one rank a card, so the multi-rank rings run on the CPU under gloo)


@pytest.fixture
def nccl_world(dev, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        from repro_torch.launch.mesh import make_local_mesh
        yield make_local_mesh()
    finally:
        dist.destroy_process_group()


def test_world_of_one_rings_on_the_card(dev, nccl_world):
    """n = 1: each ring returns the reference's n = 1 result, bitwise."""
    from repro_torch.core import pipeline_collectives as pc

    mesh = nccl_world
    assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1)
    group = mesh.get_group("model")
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 32), generator=g).to(dev)
    w = torch.randn((32, 48), generator=g).to(dev)
    assert torch.equal(pc.ring_all_gather(x, group), x)
    assert torch.equal(pc.ring_reduce_scatter(x, group), x)
    assert torch.equal(pc.overlapped_matmul_ag(x, w, group), x @ w)
    assert torch.equal(pc.overlapped_matmul_rs(x, w, group), x @ w)


@pytest.mark.parametrize("policy", ["user_level_polling",
                                    "user_level_scheduled", "kernel_level"])
def test_staged_pipeline_shardings_on_the_card(dev, nccl_world, policy):
    """Each staged leaf is a DTensor on the card, bitwise the host batch,
    with and without an engine."""
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import (
        DataConfig, StagedPipeline, SyntheticLMSource)
    from repro_torch.dist.sharding import batch_sharding_tree

    cfg = smoke_config("qwen2.5-3b")
    src = SyntheticLMSource(DataConfig(4, 64, seed=1), cfg)
    pol = getattr(TransferPolicy, policy)()
    for engine in (None, TransferEngine(pol, device=dev)):
        pipe = StagedPipeline(src, pol, engine=engine, shardings=(
            batch_sharding_tree(src.next_host_batch(0), nccl_world)))
        try:
            for step in range(3):
                got, want = next(pipe), src.next_host_batch(step)
                for k, v in want.items():
                    assert isinstance(got[k], DTensor)
                    assert got[k].to_local().is_cuda
                    np.testing.assert_array_equal(
                        got[k].to_local().cpu().numpy(), v)
        finally:
            pipe.close()
            if engine is not None:
                engine.close()


def test_kernel_wrappers_refuse_a_dtensor_on_the_card(dev, nccl_world):
    from torch.distributed.tensor import Replicate, distribute_tensor

    def dt(t):
        return distribute_tensor(t.to(dev), nccl_world,
                                 [Replicate(), Replicate()])

    x, wt, b = (dt(t) for t in _conv_case(dev, torch.float32, 1, 8, 8, 4, 8))
    m = dt(torch.randn(32, 32))
    q = dt(torch.randn(1, 64, 2, 64))
    calls = {
        "conv2d": lambda: conv2d_relu(x, wt, b),
        "matmul_blocks": lambda: matmul_blocks(m, m),
        "matmul_unique": lambda: matmul_unique(m, m),
        "flash": lambda: flash_attention(q, q, q),
        "ssd_full": lambda: ssd_full(
            dt(torch.randn(1, 16, 2, 16)), dt(torch.rand(1, 16, 2)),
            dt(-torch.rand(2)), dt(torch.randn(1, 16, 1, 8)),
            dt(torch.randn(1, 16, 1, 8)), chunk=8),
    }
    before = (dict(CONV2D.launches), dict(MATMUL.launches),
              dict(FLASH.launches), dict(SSD.launches))
    for name, fn in calls.items():
        with pytest.raises(TypeError, match="DTensor"):
            fn()
    assert before == (dict(CONV2D.launches), dict(MATMUL.launches),
                      dict(FLASH.launches), dict(SSD.launches))


def test_device_streamed_scan_from_pinned_host_is_bitwise_resident(dev):
    """A widened smoke LM (flash's head dim 64), bf16, its stacked layers
    resting in pinned host memory and copied to the card a layer ahead:
    the hidden states bitwise the resident ``stack_apply``'s, through one
    flash launch a layer."""
    from repro_torch.core.streaming import device_streamed_scan
    from repro_torch.utils.pytree import tree_map

    cfg = _small_lm(n_layers=6)[0].replace(dtype="bfloat16",
                                          use_pallas_attention=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0), dev)
    host = tree_map(lambda t: t.cpu().pin_memory(), params["blocks"])
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 256))).to(dev)
    positions = torch.arange(256, device=dev)
    with torch.no_grad():
        x0 = lm.embed_tokens(cfg, params, toks)
        want = lm.stack_apply(cfg, params, x0, None, positions)[0]
        before = FLASH.launches[SYMBOL[torch.bfloat16]]
        got = device_streamed_scan(
            lambda p, h: lm.layer_apply(cfg, "attention", p, p["attn"], h,
                                        positions=positions)[0],
            host, x0, gather_fn=lambda p: tree_map(
                lambda t: t.to(dev, non_blocking=True), p))
        torch.cuda.synchronize()
    assert FLASH.launches[SYMBOL[torch.bfloat16]] - before == cfg.n_layers
    assert got.is_cuda and torch.equal(got, want)


def test_transfer_modes_example_on_card(dev):
    """The paper's experiment on the card: the four policies' logits
    bitwise equal, the fault demo's quarantine and rejoin, the TOKEN
    class's counts (the reference's 51 / 1632)."""
    from repro_torch.examples.transfer_modes import main as tm_main

    out = tm_main([])
    rows = out["table_i"]["rows"]
    assert len(rows) == 4
    assert all(np.array_equal(r["logits"], rows[0]["logits"]) for r in rows)
    assert np.isfinite(rows[0]["logits"]).all()
    faults = out["faults"]
    assert faults["quarantined_after_tx"] == [0]
    assert faults["quarantined_after_probe"] == []
    assert faults["ledger"]["faults"] == faults["ledger"]["retries"] == \
        faults["ledger"]["retry_successes"] == 2
    assert out["unified"]["classes"]["token"] == {"completed": 51,
                                                  "bytes_total": 1632}
    assert out["coalescing"]["rx_bitwise"]


def test_dryrun_cell_predicted_equals_counted_on_the_card(dev, nccl_world):
    """A widened smoke qwen's bf16 prefill on the world-of-one mesh:
    the fake-tensor prediction's FLOPs and bytes are the card run's."""
    from repro_torch.launch.dryrun import on_device
    from repro_torch.models.config import ShapeCell

    cfg = _small_lm()[0].replace(dtype="bfloat16")
    out = on_device(cfg, ShapeCell("prefill_small", 256, 2, "prefill"),
                    nccl_world, dev)
    pred, meas = out["predicted"], out["measured"]
    assert pred["flops_per_device"] == meas["flops"] > 0
    assert pred["bytes_per_device"] == meas["bytes"]
    assert meas["max_memory_allocated_rise"] > 0 and meas["ms"] > 0


def test_dryrun_decode_cell_predicted_equals_counted_on_the_card(
        dev, nccl_world):
    """The mamba2 smoke model's f32 decode cell on the world-of-one mesh:
    a prefill of 64 tokens into the cache under the port's placements,
    then one step: the prediction's FLOPs and bytes are the card run's,
    its logits and new state within f32 reach of the plain decode's
    (rtol 1e-5, atol 1e-5), and no SSD kernel launched (``plain_ssd``)."""
    from repro_torch.kernels.ssd_scan.kernel import SSD
    from repro_torch.launch.dryrun import on_device
    from repro_torch.models.config import ShapeCell

    cfg = smoke_config("mamba2-780m").replace(dtype="float32")
    before = dict(SSD.launches)
    out = on_device(cfg, ShapeCell("decode_small", 64, 2, "decode"),
                    nccl_world, dev, plain=True)
    torch.cuda.synchronize()
    assert dict(SSD.launches) == before
    pred, meas = out["predicted"], out["measured"]
    assert pred["flops_per_device"] == meas["flops"] > 0
    assert pred["bytes_per_device"] == meas["bytes"]
    for got, want in ((out["logits"], out["plain_logits"]),
                      *zip(out["cache"], out["plain_cache"])):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
