"""The port's kernels against the reference's Pallas kernels (interpret mode)
on the same numpy inputs. On the CPU the port's wrappers run their plain
versions; the CUDA kernels themselves are checked on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``)."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d.ops import conv2d_relu as jax_conv2d_relu
from repro.kernels.streamed_matmul.kernel import (
    matmul_blocks as jax_matmul_blocks,
    matmul_unique as jax_matmul_unique,
)
from repro_torch.core.transfer import Partitioning, TransferPolicy
from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import conv2d_relu_ref
from repro_torch.kernels.streamed_matmul.kernel import (
    SMEM_BUDGET,
    TILES,
    SplitWorkspace,
    blocks_plan,
    matmul_blocks,
    matmul_unique,
    skinny,
    split_k_plan,
    split_k_ranges,
    unique_fits,
    UNIQUE_THREADS,
    unique_one_block,
    unique_plan,
)
from repro_torch.kernels.streamed_matmul.ops import block_dims_for, streamed_matmul
from repro_torch.kernels.streamed_matmul.ref import (
    matmul_blocks_split_ref,
    matmul_ref,
    matmul_unique_order_ref,
)

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

# (batch, hw, cin, cout, tile_h): tests/test_kernels.py's sweep, then the five
# RoShamBo layers (64x64x1->16 ... 4x4x128->128)
CONV_SHAPES = [(2, 16, 8, 16, 4), (2, 32, 4, 8, 8), (2, 8, 1, 16, 8),
               (1, 64, 1, 16, 8), (1, 32, 16, 32, 8), (1, 16, 32, 64, 8),
               (1, 8, 64, 128, 8), (1, 4, 128, 128, 4)]


def _conv_inputs(bsz, hw, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bsz,hw,cin,cout,tile_h", CONV_SHAPES)
def test_conv2d_matches_pallas(bsz, hw, cin, cout, tile_h, relu):
    x, w, b = _conv_inputs(bsz, hw, cin, cout)
    ref = np.asarray(jax_conv2d_relu(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), tile_h=tile_h, relu=relu,
                                     interpret=True))
    got = conv2d_relu(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), relu=relu)
    assert got.shape == (bsz, hw, hw, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_conv2d_bf16_plain_keeps_dtype():
    x, w, b = _conv_inputs(1, 8, 4, 8)
    got = conv2d_relu_ref(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    ref = conv2d_relu_ref(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               rtol=2e-2, atol=5e-2)


def _mm_inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    return jx, jw, tx, tw


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 512),
                                   (512, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_blocks_matches_pallas(m, k, n, dtype):
    jx, jw, tx, tw = _mm_inputs(m, k, n, dtype)
    ref = np.asarray(jax_matmul_blocks(jx, jw, block_m=128, block_n=128,
                                       block_k=128, interpret=True), np.float32)
    got = matmul_blocks(tx, tw, block_m=128, block_n=128, block_k=32)
    assert got.dtype == tx.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_unique_matches_pallas(dtype):
    jx, jw, tx, tw = _mm_inputs(128, 128, 128, dtype, seed=1)
    ref = np.asarray(jax_matmul_unique(jx, jw, interpret=True), np.float32)
    got = matmul_unique(tx, tw)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("part", list(Partitioning))
def test_streamed_matmul_policy_modes(part):
    _, _, tx, tw = _mm_inputs(64, 256, 96, "float32", seed=2)
    got = streamed_matmul(tx, tw, TransferPolicy(partitioning=part))
    np.testing.assert_allclose(got.numpy(), matmul_ref(tx, tw).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unique_over_budget_raises(dtype):
    # 256x256 operands are over one block's shared memory but within the
    # reference's 96 MiB UNIQUE budget: the port takes them as the
    # reference does, and matches the Pallas kernel
    jx, jw, tx, tw = _mm_inputs(256, 256, 256, dtype, seed=3)
    assert 2 * tx.numel() * tx.element_size() > SMEM_BUDGET
    ref = np.asarray(jax_matmul_unique(jx, jw, interpret=True), np.float32)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    for got in (matmul_unique(tx, tw),
                streamed_matmul(tx, tw, TransferPolicy.user_level_polling())):
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                                   atol=tol * 10)
    # (4097x4096) @ (4096x4096): over 96 MiB in f32 and in bf16; the
    # operands are broadcast views, so nothing that size is allocated
    big = torch.zeros(1, dtype=tx.dtype).expand(4097, 4096)
    sq = torch.zeros(1, dtype=tx.dtype).expand(4096, 4096)
    assert not unique_fits(4097, 4096, 4096, tx.element_size())
    with pytest.raises(ValueError, match="UNIQUE.*exceeds the VMEM budget"):
        streamed_matmul(big, sq, TransferPolicy.user_level_polling())
    with pytest.raises(ValueError, match="UNIQUE"):
        matmul_unique(big, sq)
    assert unique_fits(2048, 2048, 2048, 4)  # 48 MiB: inside
    assert unique_fits(4096, 4096, 4096, 2)  # exactly 96 MiB: inside


@pytest.mark.parametrize("block_bytes,m,n,want", [
    (1 << 20, 512, 512, (128, 128, 32)),
    (1 << 14, 512, 512, (64, 64, 32)),
    (1 << 10, 512, 512, (32, 32, 16)),
    (1 << 20, 1, 4, (32, 32, 16)),
    (1 << 20, 64, 40, (64, 64, 32)),
])
def test_block_dims_fit_shared_memory(block_bytes, m, n, want):
    got = block_dims_for(TransferPolicy(block_bytes=block_bytes), m, 256, n, 4)
    assert got == want and got in TILES
    bm, bn, bk = got
    assert (bm * bk + bk * bn) * 4 <= 48 * 1024


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    x = torch.zeros(1, 4, 4, 2, device="meta")
    w = torch.zeros(3, 3, 2, 2, device="meta")
    b = torch.zeros(2, device="meta")
    with pytest.raises(ValueError):
        conv2d_relu(x, w, b)
    with pytest.raises(ValueError):
        matmul_blocks(torch.zeros(4, 4, device="meta"),
                      torch.zeros(4, 4, device="meta"))


SMS = 132  # an H100 SXM's streaming multiprocessors

# (m, k, n): the classifier head, ragged K, one row, a grid of 4 tiles, and
# grids that fill the card (1 split) under every built tile
SPLIT_SHAPES = [(1, 2048, 4), (1, 2050, 4), (3, 1000, 10), (100, 777, 33),
                (256, 3000, 256), (512, 300, 1024), (2048, 64, 2048),
                (0, 64, 4), (4, 0, 4)]


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_split_k_plan_covers_k_once_in_whole_steps(m, k, n, tile):
    bm, bn, bk = tile
    splits, per = split_k_plan(m, n, k, tile, SMS)
    ranges = split_k_ranges(k, bk, splits, per)
    assert len(ranges) == splits >= 1
    # contiguous, in order, from 0 to K, each starting on a whole bk step
    # and none empty (unless K itself is)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 % bk == 0 and k1 - k0 <= per * bk
        assert k1 > k0 or k == 0
    tiles = -(-m // bm) * -(-n // bn)
    if tiles >= SMS:
        assert splits == 1  # the tile grid already fills the card
    assert splits == 1 or tiles * splits <= SMS
    assert blocks_plan(m, n, k, tile, SMS) == (splits, per,
                                               skinny(m, n, tile))


@pytest.mark.parametrize("m,n,tile,want", [
    (1, 4, (32, 32, 16), True),
    (1, 4, (128, 128, 32), True),
    (3, 10, (64, 64, 32), True),
    (32, 32, (32, 32, 16), False),     # the matrix fills the tile
    (100, 33, (128, 128, 32), False),  # too many outputs for the lanes
    (16, 16, (32, 32, 16), True),      # 16 x 4 units, 16 groups of 16 lanes
    (17, 16, (32, 32, 16), False),
])
def test_skinny_rule(m, n, tile, want):
    assert skinny(m, n, tile) is want


def test_split_workspace_grown_by_another_thread_keeps_the_callers_scratch():
    """A caller's scratch stays its own while a second thread grows the
    workspace of the same (device, stream) before the caller launches: the
    caller holds tensors, not addresses, and the new buffers are others."""
    ws, cpu = SplitWorkspace(), torch.device("cpu")
    part, cnt = ws.scratch(cpu, 7, 64, 4)
    assert part.numel() >= 64 and int(cnt.abs().sum()) == 0
    part.fill_(1.0)
    grown = []
    t = threading.Thread(target=lambda: grown.append(
        ws.scratch(cpu, 7, 4096, 256)))
    t.start()
    t.join()
    (gpart, gcnt), = grown
    assert gpart.numel() >= 4096 and gcnt.numel() >= 256
    assert gpart.data_ptr() != part.data_ptr()
    assert gcnt.data_ptr() != cnt.data_ptr()
    assert bool((part == 1.0).all())  # the caller's partials, untouched
    # a later call of the stream gets the grown buffers; another stream
    # has its own
    again = ws.scratch(cpu, 7, 64, 4)
    assert again[0] is gpart and again[1] is gcnt
    assert ws.scratch(cpu, 8, 64, 4)[0] is not gpart


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,blocks,tile", [
    (1, 2048, 4, (1, 4, 512), (32, 32, 16)),
    (64, 768, 96, (32, 32, 128), (64, 64, 32)),
    (256, 512, 128, (128, 128, 128), (128, 128, 32)),
])
def test_split_order_blocks_matches_pallas(m, k, n, blocks, tile, dtype):
    """The plain split-order BLOCKS (f32 partials over the planned K
    ranges, summed in slice order) against the reference's Pallas
    ``matmul_blocks`` in interpret mode."""
    jx, jw, tx, tw = _mm_inputs(m, k, n, dtype, seed=4)
    ref = np.asarray(jax_matmul_blocks(jx, jw, block_m=blocks[0],
                                       block_n=blocks[1], block_k=blocks[2],
                                       interpret=True), np.float32)
    splits, per = split_k_plan(m, n, k, tile, SMS)
    assert splits > 1
    got = matmul_blocks_split_ref(tx, tw, split_k_ranges(k, tile[2], splits,
                                                         per))
    assert got.dtype == tx.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 4), (100, 70, 33)])
def test_matmul_unique_order_matches_pallas(m, k, n, dtype):
    """UNIQUE's single block in its order (its plan's splits, the xor
    pairs inside a warp, the warps in order) against the reference's Pallas
    ``matmul_unique`` in interpret mode."""
    jx, jw, tx, tw = _mm_inputs(m, k, n, dtype, seed=5)
    ref = np.asarray(jax_matmul_unique(jx, jw, interpret=True), np.float32)
    assert unique_one_block(m, k, n, tx.element_size())
    _, splits = unique_plan(m, n, k)
    got = matmul_unique_order_ref(tx, tw, splits)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=tol,
                               atol=tol * 10)


# (m, n, k): the classifier head, the sweep's ragged shape and its cube,
# M < 4, short K, more micro-tiles than threads
@pytest.mark.parametrize("m,n,k,want", [
    (1, 4, 2048, (1, 256)),
    (100, 33, 70, (4, 1)),
    (128, 128, 128, (4, 1)),
    (3, 1, 5, (1, 4)),
    (7, 6, 9, (4, 8)),
    (1000, 100, 10, (4, 1)),
    (1, 1, 1, (1, 1)),
])
def test_unique_plan_uses_every_thread_once(m, n, k, want):
    rows, splits = unique_plan(m, n, k)
    assert (rows, splits) == want
    tiles = -(-m // rows) * -(-n // 4)
    assert splits & (splits - 1) == 0 and splits <= max(k, 1)
    # several splits only while the micro-tiles fit the block's threads,
    # and then a doubling would not fit
    assert splits == 1 or tiles * splits <= UNIQUE_THREADS
    assert tiles * splits * 2 > UNIQUE_THREADS or splits * 2 > k


def test_matmul_unique_order_with_several_warps_a_tile():
    """splits > 32: lanes pair by xor inside each warp, warps add in
    order; the same numbers as the plain product."""
    _, _, tx, tw = _mm_inputs(2, 4096, 4, "float32", seed=6)
    assert unique_plan(2, 4, 4096) == (1, 128)
    np.testing.assert_allclose(matmul_unique_order_ref(tx, tw, 128).numpy(),
                               matmul_ref(tx, tw).numpy(), rtol=1e-5,
                               atol=1e-4)
