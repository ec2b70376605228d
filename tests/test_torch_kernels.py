"""The port's kernels against the reference's Pallas kernels (interpret mode)
on the same numpy inputs. On the CPU the port's wrappers run their plain
versions; the CUDA kernels themselves are checked on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``)."""

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
    matmul_blocks,
    matmul_unique,
)
from repro_torch.kernels.streamed_matmul.ops import block_dims_for, streamed_matmul
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

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


def test_unique_over_budget_raises():
    # 256x256 f32 operands: 512 KiB, over one block's 227 KB of shared memory
    x = torch.zeros(256, 256)
    assert (2 * x.numel() * 4) > SMEM_BUDGET
    with pytest.raises(ValueError, match="UNIQUE"):
        streamed_matmul(x, x, TransferPolicy.user_level_polling())
    with pytest.raises(ValueError, match="UNIQUE"):
        matmul_unique(x, x)
    # BLOCKS takes the same operands
    assert streamed_matmul(x, x, TransferPolicy()).shape == (256, 256)


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
