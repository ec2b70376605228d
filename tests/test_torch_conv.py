"""The conv2d kernel's plan and its split-order plain version against the
reference's Pallas conv (interpret mode) on the same numpy inputs; the
plain pooled and counted version against the pool of the plain conv. The
CUDA kernel itself is held against both on the card
(tests/test_torch_cuda.py and ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel.roshambo import maxpool2 as jax_maxpool2
from repro.kernels.conv2d.ops import conv2d_relu as jax_conv2d_relu
from repro_torch.kernels import _split
from repro_torch.kernels.conv2d import kernel as conv_kernel
from repro_torch.kernels.conv2d.kernel import CONV_TILE, conv_plan, conv_ranges
from repro_torch.kernels.conv2d.ops import conv2d_relu
from repro_torch.kernels.conv2d.ref import (
    conv2d_relu_ref,
    conv2d_split_ref,
    maxpool2,
)
from repro_torch.kernels.streamed_matmul import kernel as mm_kernel

# one intra-op thread a worker process (see tests/test_torch_kernels.py)
torch.set_num_threads(1)

# the five RoShamBo layers (hw, cin, cout)
ROSHAMBO = [(64, 1, 16), (32, 16, 32), (16, 32, 64), (8, 64, 128),
            (4, 128, 128)]


def _inputs(bsz, h, w, cin, cout, kh=3, kw=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((kh, kw, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, b


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("bsz", [1, 32])
@pytest.mark.parametrize("hw,cin,cout", ROSHAMBO)
def test_conv_plan_covers_k_once_and_fills_the_card(hw, cin, cout, bsz, sms):
    bm, bn, bk = CONV_TILE
    tile, splits, per = conv_plan(bsz, hw, hw, cin, cout, 3, 3, sms)
    assert tile == CONV_TILE
    k = 9 * cin
    ranges = conv_ranges(3, 3, cin, splits, per)
    # contiguous, in order, from 0 to K, whole chunks, none empty
    assert len(ranges) == splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (_, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    for k0, k1 in ranges:
        assert k0 % bk == 0 and 0 < k1 - k0 <= per * bk
    tiles = -(-bsz * hw * hw // bm) * -(-cout // bn)
    assert splits * tiles <= max(sms, tiles)
    if tiles >= sms:
        assert splits == 1  # the tiles already fill the card


def test_conv_plan_at_batch_1_splits_the_deep_layers():
    """At batch 1 on an H100's 132 SMs conv1 (K = 9, one chunk) keeps one
    split and conv2-conv5 split K; at batch 32 only conv5's 32 tiles
    leave room to split."""
    b1 = [conv_plan(1, hw, hw, cin, cout, 3, 3, 132)[1:]
          for hw, cin, cout in ROSHAMBO]
    assert b1 == [(1, 1), (5, 1), (9, 1), (18, 1), (18, 2)]
    b32 = [conv_plan(32, hw, hw, cin, cout, 3, 3, 132)[1]
           for hw, cin, cout in ROSHAMBO]
    assert b32 == [1, 1, 1, 1, 4]


def test_conv_and_blocks_share_one_split_workspace():
    assert conv_kernel.SPLIT_WORKSPACE is _split.SPLIT_WORKSPACE
    assert mm_kernel.SPLIT_WORKSPACE is _split.SPLIT_WORKSPACE
    assert mm_kernel.SplitWorkspace is _split.SplitWorkspace


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("hw,cin,cout", ROSHAMBO)
def test_conv2d_split_ref_matches_pallas(hw, cin, cout, relu):
    """Each layer's real Cin / Cout at 8 x 8, summed over the K ranges of
    the layer's own plan (batch 1, 132 and 8 SMs), against the Pallas conv
    in interpret mode."""
    x, w, b = _inputs(1, 8, 8, cin, cout, seed=hw)
    ref = np.asarray(jax_conv2d_relu(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), tile_h=8, relu=relu,
                                     interpret=True))
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    for sms in (132, 8):
        _, splits, per = conv_plan(1, hw, hw, cin, cout, 3, 3, sms)
        got = conv2d_split_ref(tx, tw, tb, conv_ranges(3, 3, cin, splits,
                                                       per), relu=relu)
        assert got.shape == (1, 8, 8, cout) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def _pallas_conv(x, w, b, relu):
    return np.asarray(jax_conv2d_relu(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(b), tile_h=8, relu=relu,
                                      interpret=True))


@pytest.mark.parametrize("relu", [True, False])
def test_conv2d_relu_ref_adds_the_bias_after_the_dots(relu):
    """The CPU path sums as the reference kernel does: the K x K dots from
    zero, then the bias. With a bias of 2**24 every 0.5 would be lost
    against a bias added first (each sum is 2**24 + 0.5, a tie rounded to
    even); after the dots an interior pixel's 4.5 rounds to 2**24 + 4 and
    a corner's 2.0 is exact."""
    x = np.ones((1, 8, 8, 1), np.float32)
    w = np.full((3, 3, 1, 2), 0.5, np.float32)
    b = np.full(2, 2.0 ** 24, np.float32)
    want = _pallas_conv(x, w, b, relu)
    got = conv2d_relu_ref(*(torch.from_numpy(a) for a in (x, w, b)),
                          relu=relu).numpy()
    assert want[0, 3, 3, 0] == 2.0 ** 24 + 4 and want[0, 0, 0, 0] == 2.0 ** 24 + 2
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("hw,cin,cout", ROSHAMBO)
def test_conv2d_relu_ref_matches_pallas(hw, cin, cout, relu):
    """Each RoShamBo layer's Cin / Cout at 8 x 8 on random inputs, the CPU
    path against the Pallas conv in interpret mode, at the split-order
    version's tolerance."""
    x, w, b = _inputs(2, 8, 8, cin, cout, seed=hw + 1)
    got = conv2d_relu_ref(*(torch.from_numpy(a) for a in (x, w, b)),
                          relu=relu)
    assert got.shape == (2, 8, 8, cout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pallas_conv(x, w, b, relu),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bsz,h,w,cin,cout,kh,kw", [
    (2, 7, 9, 3, 5, 3, 3),
    (1, 5, 6, 4, 7, 5, 3),
])
def test_conv2d_split_ref_ragged_matches_plain(bsz, h, w, cin, cout, kh, kw):
    """Shapes no tile divides, and a 5 x 3 kernel, in the kernel's K order
    against the plain shifted-dot version, f32 and bf16."""
    x, wt, b = _inputs(bsz, h, w, cin, cout, kh, kw, seed=3)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, b))
    _, splits, per = conv_plan(bsz, h, w, cin, cout, kh, kw, 132)
    ranges = conv_ranges(kh, kw, cin, splits, per)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        args = [t.to(dtype) for t in (tx, tw, tb)]
        got = conv2d_split_ref(*args, ranges, relu=False)
        assert got.dtype == dtype
        np.testing.assert_allclose(
            got.float().numpy(),
            conv2d_relu_ref(*args, relu=False).float().numpy(),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("pool", [True, False])
@pytest.mark.parametrize("bsz,h,w,cin,cout", [
    *[(2, 8, 8, cin, cout) for _, cin, cout in ROSHAMBO],
    (2, 7, 9, 3, 5),   # odd H and W: the pool drops the last row and column
    (1, 5, 6, 4, 7),   # odd H only
])
def test_conv2d_relu_pool_ref_is_the_pool_of_the_conv(bsz, h, w, cin, cout,
                                                      pool, relu):
    """The plain pooled and counted version: ``maxpool2`` of
    ``conv2d_relu_ref`` (and the reference package's ``maxpool2`` of the
    same output), its nonzeros added to the element of the buffer that it
    is given a view of and to no other; the CPU path of ``conv2d_relu``
    takes it and adds again."""
    x, wt, b = (torch.from_numpy(a)
                for a in _inputs(bsz, h, w, cin, cout, seed=h + cin))
    full = conv2d_relu_ref(x, wt, b, relu=relu)
    want = maxpool2(full) if pool else full
    counts = torch.zeros(3, dtype=torch.int32)
    got = conv2d_relu_ref(x, wt, b, relu=relu, pool=pool, counts=counts[1])
    assert torch.equal(got, want)
    if pool:
        assert got.shape == (bsz, h // 2, w // 2, cout)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax_maxpool2(jnp.asarray(full.numpy()))))
    nz = int(torch.count_nonzero(want))
    assert 0 < nz < want.numel() or not relu
    assert counts.tolist() == [0, nz, 0]
    again = conv2d_relu(x, wt, b, relu=relu, pool=pool, counts=counts[1])
    assert torch.equal(again, want)
    assert counts.tolist() == [0, 2 * nz, 0]
