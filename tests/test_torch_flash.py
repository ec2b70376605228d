"""The port's flash attention against the reference's Pallas kernel
(interpret mode) on the same numpy inputs. On the CPU the port's wrappers
run their plain version; the CUDA kernel itself is held against that
plain version on the card (tests/test_torch_cuda.py and
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import (
    flash_attention_bhsd as jax_flash_bhsd,
)
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    TC_BLOCK_KV,
    TC_BLOCK_Q,
    TC_WARPGROUP_Q,
    flash_attention_bshd,
    visible_kv_tiles,
)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

# tests/test_kernels.py's sweep (causal assumes aligned q/kv, so the causal
# cases with Sq != Skv are not generated)
SWEEP = [(sq, skv, causal, window, n_rep)
         for sq, skv in [(128, 128), (256, 512)]
         for causal, window in [(True, 0), (False, 0), (True, 96)]
         for n_rep in [1, 4]
         if not (causal and sq != skv)]


def _bhsd_inputs(bh, sq, skv, dh, n_rep, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, sq, dh)).astype(np.float32)
    k = rng.standard_normal((bh // n_rep, skv, dh)).astype(np.float32)
    v = rng.standard_normal((bh // n_rep, skv, dh)).astype(np.float32)
    return q, k, v


def _as_bshd(q, k, v):
    """[BH, S, D] (kv head h // n_rep for query head h) as one batch of
    [1, S, H, D] tensors, the layout the port's wrapper takes: the same
    transposes the reference's ``ops.flash_attention`` applies."""
    return tuple(torch.from_numpy(a).transpose(0, 1)[None].contiguous()
                 for a in (q, k, v))


def _bhsd(o):
    return o[0].transpose(0, 1).numpy()


def _bshd_inputs(b, sq, skv, h, hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,skv,causal,window,n_rep", SWEEP)
def test_flash_bhsd_matches_pallas(sq, skv, causal, window, n_rep):
    q, k, v = _bhsd_inputs(4, sq, skv, 64, n_rep)
    ref = np.asarray(jax_flash_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, block_q=64, block_kv=64, n_rep=n_rep, interpret=True))
    got = flash_attention(*_as_bshd(q, k, v), causal=causal, window=window)
    assert got.dtype == torch.float32
    assert _bhsd(got).shape == ref.shape
    np.testing.assert_allclose(_bhsd(got), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_bshd_wrapper_matches_pallas(causal, window):
    q, k, v = _bshd_inputs(2, 128, 128, 8, 2, 64, seed=1)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               block_q=64, block_kv=64, interpret=True))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window)
    assert got.shape == (2, 128, 8, 64)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_flash_bf16_matches_pallas():
    # tests/test_kernels.py::test_flash_attention_bf16's shapes and
    # tolerance
    q, k, v = _bshd_inputs(2, 128, 128, 4, 2, 32, seed=2)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(jax_flash(jq, jk, jv, block_q=64, block_kv=64,
                               interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("s,window", [(100, 0), (1000, 96), (77, 200)])
def test_flash_ragged_s_matches_reference_oracle(s, window):
    # the reference's kernel asserts that S divides into its blocks; the
    # port takes any S, and its result is the reference's plain oracle's
    q, k, v = _bhsd_inputs(4, s, s, 64, 2, seed=3)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       window=window, n_rep=2))
    got = flash_attention(*_as_bshd(q, k, v), causal=True, window=window)
    np.testing.assert_allclose(_bhsd(got), ref, rtol=2e-4, atol=2e-4)


def test_fully_masked_row_averages_instead_of_nan():
    # non-causal, window 1, Sq > Skv: query rows 2 and 3 see no key; the
    # finite NEG_INF gives them the plain average of v, as in the reference
    q, k, v = _bhsd_inputs(2, 4, 2, 64, 1, seed=4)
    ref = np.asarray(jax_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=False,
                                       window=1))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=False,
                        window=1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:, 3], v.mean(axis=1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)


def test_plain_bshd_equals_bhsd_layout():
    # the [B, S, H, D] plain version is ref.py's [BH, S, D] function on the
    # transposed tensors, with query head h reading kv head h // n_rep
    q, k, v = _bshd_inputs(2, 64, 64, 4, 2, 64, seed=5)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=True, window=16)
    flat = attention_ref(
        tq.transpose(1, 2).reshape(8, 64, 64),
        tk.transpose(1, 2).reshape(4, 64, 64),
        tv.transpose(1, 2).reshape(4, 64, 64), causal=True, window=16,
        n_rep=2)
    torch.testing.assert_close(got, flat.reshape(2, 4, 64, 64).transpose(1, 2))


@pytest.mark.parametrize("d", [64, 96])
def test_wrappers_refuse_non_cuda_tensors(d):
    # a tensor that is neither on the CPU nor on a card (meta) is refused,
    # never sent to the plain version; so is a head dim the kernel lacks
    q = torch.zeros(1, 8, 2, d, device="meta")
    k = torch.zeros(1, 8, 1, d, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
    with pytest.raises(ValueError):
        flash_attention_bshd(q, k, k)


def _admitted(sq, skv, causal, window):
    """[Sq, Skv] bool: the (q, k) pairs the mask admits (ref.py's rule)."""
    qpos = np.arange(sq)[:, None]
    kpos = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return ok


@pytest.mark.parametrize("bq", [TC_BLOCK_Q, TC_WARPGROUP_Q])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (2048, 2048, True, 0), (4096, 4096, True, 1024), (1000, 1000, True, 96),
    (200, 333, False, 0), (333, 333, True, 0), (77, 77, True, 0),
    (640, 640, False, 200), (300, 190, False, 0), (1, 300, False, 0),
    (129, 129, True, 64), (200, 90, True, 0), (90, 200, True, 0),
])
def test_visible_kv_tiles_cover_the_mask_and_nothing_else(sq, skv, causal,
                                                         window, bq):
    """At the tensor-core kernel's tiles (128-row blocks, 64-row
    warpgroups, 64-key tiles): every (q, k) pair the mask admits lies in a
    visited tile of its q tile, and every visited tile holds such a pair
    (none is masked for every row)."""
    ok = _admitted(sq, skv, causal, window)
    bkv = TC_BLOCK_KV
    for q0 in range(0, sq, bq):
        rows = ok[q0:q0 + bq]
        t_lo, t_hi = visible_kv_tiles(q0, bq, bkv, sq, skv, causal, window)
        seen = np.nonzero(rows.any(axis=0))[0]
        if seen.size == 0:
            assert t_hi <= t_lo
            continue
        assert t_lo * bkv <= seen.min() and seen.max() < t_hi * bkv
        for t in range(t_lo, t_hi):
            assert rows[:, t * bkv:(t + 1) * bkv].any(), (q0, t)
    # rows past Sq see nothing
    assert visible_kv_tiles(sq, bq, bkv, sq, skv, causal, window) == (0, 0)
