"""The SSD kernel slice on the CPU: the port's plain SSD (``ref.py``,
``ops.ssd_full``) and its ``ssm.py`` helpers, held against the reference's
Pallas kernel in interpret mode and its jnp functions on the same
numpy-seeded inputs; the CUDA binding's refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_call as jssd_call
from repro.kernels.ssd_scan.ops import ssd_full as jssd_full
from repro.models.layers import ssm as jssm
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import (
    ssd_full, ssd_intra_chunk, ssd_state_pass)
from repro_torch.kernels.ssd_scan.ref import (
    ssd_intra_chunk_ref, ssd_state_pass_ref)
from repro_torch.models.layers import ssm

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

# f32: the reference's own kernel-vs-oracle tolerance (test_kernels.py).
# bf16: x, B, C, x*dt, att and the state decay are rounded to bf16 at the
# same points on both sides and summed in f32, so the roundings land alike
# (max |d| 1.2e-7 over this sweep); 2e-3 leaves room for one att element
# of |value| <= 0.5 rounding the other way after f32 noise
F32_TOL = 1e-4
BF16_TOL = 2e-3


def _inputs(bs, s, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bs, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    b = (rng.standard_normal((bs, s, g, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bs, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, b, c


def _jax(x, dt, a, b, c, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return (jnp.asarray(x, jd), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b, jd), jnp.asarray(c, jd))


def _torch(x, dt, a, b, c, dtype):
    td = getattr(torch, dtype)
    return (torch.from_numpy(x).to(td), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(b).to(td),
            torch.from_numpy(c).to(td))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_intra_chunk_ref_matches_pallas(chunk, g, dtype):
    args = _inputs(2, 64, 4, 16, g, 8, seed=chunk + g)
    want = jssd_call(*_jax(*args, dtype), chunk=chunk, interpret=True)
    got = ssd_intra_chunk_ref(*_torch(*args, dtype), chunk=chunk)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    names = ("y_diag", "states", "chunk_decay")
    for name, gt, wt in zip(names, got, want):
        assert gt.dtype == torch.float32, name
        assert tuple(gt.shape) == wt.shape, name
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_full_matches_reference(with_state, dtype):
    """In bf16 too: the port's model path keeps the reference ssd_full's
    rounding points (not ssd_chunked's, which keeps x * dt in f32)."""
    args = _inputs(2, 64, 4, 16, 1, 8, seed=5)
    init = (np.random.default_rng(6).standard_normal((2, 4, 16, 8))
            .astype(np.float32) if with_state else None)
    jy, jf = jssd_full(*_jax(*args, dtype), chunk=16, interpret=True,
                       initial_state=None if init is None
                       else jnp.asarray(init))
    ty, tf = ssd_full(*_torch(*args, dtype), chunk=16,
                      initial_state=None if init is None
                      else torch.from_numpy(init))
    assert str(ty.dtype).split(".")[1] == dtype and tf.dtype == torch.float32
    # bf16: y is rounded to bf16 last; one step of it is 2^-8 relative
    tol = F32_TOL if dtype == "float32" else 8e-3
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ssd_full_matches_ssd_chunked():
    # the reference's test_ssd_full_matches_model_path, in the port
    args = _torch(*_inputs(2, 64, 4, 16, 2, 8, seed=7), "float32")
    y1, f1 = ssd_full(*args, chunk=16)
    y2, f2 = ssm.ssd_chunked(*args, chunk=16, return_final_state=True)
    torch.testing.assert_close(y1, y2, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(f1, f2, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    args = _inputs(2, 48, 4, 16, 2, 8, seed=8)
    init = (np.random.default_rng(9).standard_normal((2, 4, 16, 8))
            .astype(np.float32) if with_state else None)
    jy, jf = jssm.ssd_chunked(*_jax(*args, "float32"), chunk=16,
                              initial_state=None if init is None
                              else jnp.asarray(init),
                              return_final_state=True)
    ty, tf = ssm.ssd_chunked(*_torch(*args, "float32"), chunk=16,
                             initial_state=None if init is None
                             else torch.from_numpy(init),
                             return_final_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=F32_TOL,
                               atol=F32_TOL)


def test_segsum_matches_reference():
    x = -np.abs(np.random.default_rng(10).standard_normal((3, 2, 12))
                ).astype(np.float32)
    want = np.asarray(jssm.segsum(jnp.asarray(x)))
    got = ssm.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def test_decode_step_matches_reference():
    rng = np.random.default_rng(11)
    bs, h, p, g, n = 2, 4, 16, 2, 8
    state = rng.standard_normal((bs, h, p, n)).astype(np.float32)
    x = rng.standard_normal((bs, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bs, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    b = rng.standard_normal((bs, g, n)).astype(np.float32)
    c = rng.standard_normal((bs, g, n)).astype(np.float32)
    jy, jst = jssm.ssd_decode_step(*(jnp.asarray(v) for v in
                                     (state, x, dt, a, b, c)))
    ty, tst = ssm.ssd_decode_step(*(torch.from_numpy(v) for v in
                                    (state, x, dt, a, b, c)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)


def test_ragged_sequence_raises():
    args = _torch(*_inputs(1, 40, 4, 16, 1, 8), "float32")
    with pytest.raises(ValueError, match="divisible"):
        ssd_intra_chunk_ref(*args, chunk=16)
    with pytest.raises(ValueError, match="divisible"):
        ssd_full(*args, chunk=16)
    with pytest.raises(ValueError, match="divisible"):
        ssm.ssd_chunked(*args, chunk=16)


def test_cpu_tensors_take_the_plain_version():
    args = _torch(*_inputs(1, 32, 4, 16, 1, 8, seed=12), "float32")
    launches = dict(ssd_kernel.SSD.launches)
    for use_kernel in (True, False):
        got = ssd_intra_chunk(*args, chunk=16, use_kernel=use_kernel)
        want = ssd_intra_chunk_ref(*args, chunk=16)
        for gt, wt in zip(got, want):
            assert torch.equal(gt, wt)
    assert ssd_kernel.SSD.launches == launches


def test_plain_ssd_passes_use_kernel_false_within(monkeypatch):
    """``plain_ssd()`` makes every ``ssd_full`` call within it take the
    plain versions (``use_kernel=False``, as the dry run's card tie asks),
    and only within it: the same values as ``use_kernel=False``."""
    from repro_torch.kernels.ssd_scan import ops

    seen = []
    orig = ops.ssd_intra_chunk

    def spy(*args, use_kernel=True, **kw):
        seen.append(use_kernel)
        return orig(*args, use_kernel=use_kernel, **kw)

    monkeypatch.setattr(ops, "ssd_intra_chunk", spy)
    args = _torch(*_inputs(1, 32, 4, 16, 1, 8, seed=13), "float32")
    want = ssd_full(*args, chunk=16, use_kernel=False)
    with ops.plain_ssd():
        with ops.plain_ssd():  # nested: still plain after the inner exit
            pass
        got = ssd_full(*args, chunk=16)
    ssd_full(*args, chunk=16)
    assert seen == [False, False, True]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_binding_refuses_cpu_tensors():
    args = _torch(*_inputs(1, 32, 4, 16, 1, 8), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_intra_chunk_call(*args, chunk=16)


def _ssm_configs():
    """Every registered config (full and smoke) that runs the SSD: the
    families with Mamba2 layers."""
    from repro_torch.configs.registry import ARCHS, get_config, smoke_config
    out = []
    for arch in ARCHS:
        for get in (get_config, smoke_config):
            try:
                cfg = get(arch)
            except NotImplementedError:  # a family the port has not reached
                continue
            if cfg.family in ("ssm", "hybrid"):
                out.append(cfg)
    return out


def test_kernel_shape_table_covers_the_configs():
    cfgs = _ssm_configs()
    assert {c.name for c in cfgs} >= {"mamba2-780m", "zamba2-1.2b"}
    for cfg in cfgs:
        assert cfg.ssm_chunk in ssd_kernel.CHUNKS, cfg.name
        assert cfg.ssm_head_dim in ssd_kernel.HEAD_DIMS, cfg.name
        assert cfg.ssm_state in ssd_kernel.STATE_DIMS, cfg.name
        # the bf16 kernel's head slices divide each group's heads
        rep = cfg.n_ssm_heads // cfg.ssm_groups
        for sms in (132, 8):
            hs = ssd_kernel.ssd_slice(2, 8, cfg.n_ssm_heads, cfg.ssm_groups,
                                      cfg.ssm_chunk, sms)
            assert 1 <= hs <= ssd_kernel.MAX_SLICE and rep % hs == 0


def test_ssd_slice_at_the_scoring_shapes():
    """B 2 x S 2048 (8 chunks of 256, 4 q tiles each) on 132 SMs: mamba2's
    48 heads in 8 slices of 6 (640 blocks, C.B formed 8 times a (batch,
    chunk, tile) instead of 48), zamba2's 64 in 8 of 8; a card of 8 SMs
    keeps the largest slice; a grid too small for any slice takes one head
    a block."""
    assert ssd_kernel.ssd_slice(2, 8, 48, 1, 256, 132) == 6
    assert ssd_kernel.ssd_slice(2, 8, 64, 1, 256, 132) == 8
    assert ssd_kernel.ssd_slice(2, 8, 48, 1, 256, 8) == 8
    assert ssd_kernel.ssd_slice(2, 8, 48, 2, 256, 132) == 6
    assert ssd_kernel.ssd_slice(1, 2, 4, 2, 16, 132) == 1


def _reference_scan(states, decay, init):
    """The reference ``ssd_full``'s lax.scan (its body is local to that
    function), on the [B,nc,...] layout: (prev states, final state)."""
    def body(prev, inp):
        st_z, dec_z = inp
        return prev * dec_z[..., None, None] + st_z, prev

    final, prev = jax.lax.scan(body, init, (jnp.swapaxes(states, 0, 1),
                                            jnp.swapaxes(decay, 0, 1)))
    return np.asarray(jnp.swapaxes(prev, 0, 1)), np.asarray(final)


@pytest.mark.parametrize("with_state", [False, True])
def test_state_pass_ref_matches_reference_scan(with_state):
    rng = np.random.default_rng(13)
    bs, nc, h, p, n = 2, 5, 3, 16, 8
    states = rng.standard_normal((bs, nc, h, p, n)).astype(np.float32)
    decay = np.exp(-rng.random((bs, nc, h)) * 4).astype(np.float32)
    init = (rng.standard_normal((bs, h, p, n)).astype(np.float32)
            if with_state else None)
    wprev, wfinal = _reference_scan(
        jnp.asarray(states), jnp.asarray(decay),
        jnp.zeros((bs, h, p, n), jnp.float32) if init is None
        else jnp.asarray(init))
    prev, final = ssd_state_pass_ref(
        torch.from_numpy(states), torch.from_numpy(decay),
        None if init is None else torch.from_numpy(init))
    assert prev.dtype == final.dtype == torch.float32
    np.testing.assert_allclose(prev.numpy(), wprev, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(final.numpy(), wfinal, rtol=F32_TOL,
                               atol=F32_TOL)


def test_state_pass_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(14)
    states = torch.from_numpy(
        rng.standard_normal((1, 3, 2, 16, 8)).astype(np.float32))
    decay = torch.from_numpy(rng.random((1, 3, 2)).astype(np.float32))
    launches = dict(ssd_kernel.SSD.launches)
    got = ssd_state_pass(states, decay)
    want = ssd_state_pass_ref(states, decay)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)
    assert ssd_kernel.SSD.launches == launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_state_pass_call(states, decay)
