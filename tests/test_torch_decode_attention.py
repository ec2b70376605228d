"""The decode-attention kernel's plain version and its route, on the CPU.

The plain version (``kernels/decode_attention/ref.py``) against the
model's plain routes (``attention_unique`` / ``attention_blocks``) over a
cache with ragged per-slot lengths; which calls take the kernel (fake CUDA
tensors, so the choice is made as on the card); the CPU path bitwise as
the plain route at the chat and rag decode shapes; and the serving
engine's decode graph, which a CPU engine never takes."""

import math

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import smoke_config
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref,
    live_rows,
)
from repro_torch.models import lm
from repro_torch.models.api import build_model
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers.attention import KVCache, _cache_write
from repro_torch.serve.continuous import ContinuousBatchingEngine, Request


def _case(b, s_max, h, hkv, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((b, 1, h, dh), generator=g).to(dtype)
    k = torch.randn((b, s_max, hkv, dh), generator=g).to(dtype)
    v = torch.randn((b, s_max, hkv, dh), generator=g).to(dtype)
    return q, k, v


def _lengths(b, s_max):
    """Ragged [B] lengths: an empty slot, a full one (S_max - 1 cached),
    an idle slot past S_max, and others between."""
    rng = np.random.default_rng(s_max)
    mid = rng.integers(1, s_max - 1, b - 3)
    return torch.tensor([0, s_max - 1, s_max + 7, *mid], dtype=torch.int64)


def _model_route(q, k, v, length, *, threshold, chunk, scale):
    """The model's plain route over a cache written at ``length``: causal
    from position ``length``, rows below ``length + 1`` valid."""
    return attn.attention(q, k, v, causal=True, window=0, q_offset=length,
                          kv_valid=length + 1, kv_chunk=chunk,
                          blocks_threshold=threshold, scale=scale)


# S_max below the blocks threshold (unique) and above it (blocks, padded
# to a chunk multiple); groups of 2 and 4 and head dims 64 and 128, as
# granite.chat and granite4h.rag decode
@pytest.mark.parametrize("s_max", [48, 80])
@pytest.mark.parametrize("h,hkv,dh", [(4, 2, 64), (8, 2, 128)])
@pytest.mark.parametrize("per_slot", [True, False])
def test_plain_version_matches_the_model_routes(s_max, h, hkv, dh, per_slot):
    """f32: within 1e-5 of the model's route (the same sums in another
    order). bf16: both within bf16's rounding of the f32 route (the plain
    version rounds p before its normalisation, the unique route after it),
    by flash's bf16 rule, 2e-2 |ref| + 0.05 RMS of the row.

    The blocks route pads the cache to a chunk multiple and masks by
    ``length + 1`` alone, so a slot whose length has passed S_max (an idle
    slot, whose token nobody reads) also attends the zero rows of the
    padding; the plain version attends the S_max rows, as the unique
    route does. There the plain version is held to the unique route."""
    b, threshold, chunk, scale = 5, 64, 32, 0.17
    length = _lengths(b, s_max) if per_slot else s_max // 2
    blocks = s_max > threshold
    past = (torch.as_tensor(length) >= s_max).expand(b)
    q, k, v = _case(b, s_max, h, hkv, dh, torch.float32)

    def route(*qkv, over=s_max):
        out = _model_route(*qkv, length, threshold=threshold, chunk=chunk,
                           scale=scale)
        if blocks and past.any():
            whole = _model_route(*qkv, length, threshold=over, chunk=chunk,
                                 scale=scale)
            out = torch.where(past[:, None, None, None], whole, out)
        return out

    got = decode_attention_ref(q, k, v, length, scale=scale)
    torch.testing.assert_close(got, route(q, k, v), rtol=0, atol=1e-5)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    oracle = route(qb.float(), kb.float(), vb.float())
    atol = 0.05 * oracle.pow(2).mean(-1, keepdim=True).sqrt()
    for out in (decode_attention_ref(qb, kb, vb, length, scale=scale),
                route(qb, kb, vb)):
        assert out.dtype == torch.bfloat16
        diff = (out.float() - oracle).abs()
        assert bool((diff <= atol + 2e-2 * oracle.abs()).all()), float(
            diff.max())


def test_live_rows_and_the_wrappers_cpu_path():
    """Rows min(length + 1, S_max), for an int, a 0-d and a [B] length;
    the wrapper takes the plain version for CPU tensors; the scale
    defaults to 1/sqrt(Dh)."""
    assert live_rows(5, 3, 8, "cpu").tolist() == [6, 6, 6]
    assert live_rows(torch.tensor(9), 2, 8, "cpu").tolist() == [8, 8]
    assert live_rows(torch.tensor([0, 7, 30]), 3, 8, "cpu").tolist() == [
        1, 8, 8]
    q, k, v = _case(3, 16, 4, 2, 64, torch.bfloat16)
    n = torch.tensor([3, 15, 40])
    assert torch.equal(decode_attention(q, k, v, n),
                       decode_attention_ref(q, k, v, n,
                                            scale=1 / math.sqrt(64)))


def _fake(shape, dtype=torch.bfloat16, device="cuda"):
    return torch.empty(shape, dtype=dtype, device=device)


# (what, q shape, cache shape, dtype, device, window, kv_heads, takes it)
ROUTES = [
    ("chat decode", (64, 1, 16, 64), (64, 2560, 8, 64), torch.bfloat16,
     "cuda", 0, False, True),
    ("rag decode", (64, 1, 32, 128), (64, 4608, 8, 128), torch.bfloat16,
     "cuda", 0, False, True),
    ("a group of 8", (2, 1, 16, 128), (2, 64, 2, 128), torch.bfloat16,
     "cuda", 0, False, True),
    ("prefill", (1, 512, 16, 64), (1, 2560, 8, 64), torch.bfloat16, "cuda",
     0, False, False),
    ("sliding window", (4, 1, 16, 64), (4, 512, 8, 64), torch.bfloat16,
     "cuda", 128, False, False),
    ("heads a shard picks", (4, 1, 16, 64), (4, 512, 8, 64), torch.bfloat16,
     "cuda", 0, True, False),
    ("f32", (4, 1, 16, 64), (4, 512, 8, 64), torch.float32, "cuda", 0,
     False, False),
    ("head dim 80", (4, 1, 16, 80), (4, 512, 8, 80), torch.bfloat16, "cuda",
     0, False, False),
    ("a group of 3", (4, 1, 6, 64), (4, 512, 2, 64), torch.bfloat16, "cuda",
     0, False, False),
    ("cpu", (4, 1, 16, 64), (4, 512, 8, 64), torch.bfloat16, "cpu", 0,
     False, False),
]


@pytest.mark.parametrize("what,qs,cs,dtype,device,window,kv_heads,takes",
                         ROUTES, ids=[r[0] for r in ROUTES])
def test_which_calls_take_the_kernel(what, qs, cs, dtype, device, window,
                                     kv_heads, takes):
    with FakeTensorMode():
        q, ck = _fake(qs, dtype, device), _fake(cs, dtype, device)
        heads = _fake((qs[2],), torch.int64, device) if kv_heads else None
        assert attn._decode_route(q, ck, window=window,
                                  kv_heads=heads) is takes


@pytest.mark.parametrize("s,cross,takes", [(1, False, True),
                                           (3, False, False),
                                           (1, True, False)])
def test_attend_sends_one_token_against_the_cache_to_the_kernel(
        monkeypatch, s, cross, takes):
    """``_attend`` with the route decided as for the same tensors on the
    card: a one-token self-attention step against a cache calls the
    kernel once, with the cache as written and the length before the
    step, and returns the advanced cache; a prompt and cross-attention do
    not call it."""
    calls = []
    route = attn._decode_route

    def on_card(q, ck, **kw):
        with FakeTensorMode():
            return route(_fake(q.shape, q.dtype), _fake(ck.shape, ck.dtype),
                         **kw)

    def kernel(q, k, v, length, *, scale=None):
        calls.append((k, v, length, scale))
        return torch.zeros_like(q)

    monkeypatch.setattr(attn, "_decode_route", on_card)
    monkeypatch.setattr(attn, "decode_attention", kernel)
    g = torch.Generator().manual_seed(s)
    q, k, v = (torch.randn((4, s, n, 64), generator=g).to(torch.bfloat16)
               for n in (16, 8, 8))
    cache = KVCache(*_case(4, 256, 16, 8, 64, torch.bfloat16)[1:],
                    torch.tensor([0, 5, 255, 300]))
    out, new = attn._attend(q, None if cross else k, None if cross else v,
                            rope_theta=1e4, window=0, kv_chunk=1024,
                            blocks_threshold=4096, use_pallas=False,
                            cache=cache, positions=None, cross=cross,
                            causal=True, scale=0.125)
    assert out.shape == q.shape
    assert len(calls) == int(takes)
    if takes:
        (ck, cv, length, scale), = calls
        assert ck is cache.k and cv is cache.v and length is cache.length
        assert scale == 0.125 and torch.equal(out, torch.zeros_like(q))
        assert new.k is cache.k and torch.equal(new.length, cache.length + 1)


# granite.chat's decode (16 / 8 heads of 64, S_max 2,560: the unique
# route) and granite4h.rag's (32 / 8 of 128, S_max 4,608: blocks)
@pytest.mark.parametrize("h,hkv,dh,s_max,scale", [
    (16, 8, 64, 2560, None), (32, 8, 128, 4608, 0.0078125)])
def test_attend_on_the_cpu_is_the_plain_route(h, hkv, dh, s_max, scale):
    """A CPU decode step through ``_attend`` is bitwise the plain route
    over the cache it wrote, at the chat and rag decode shapes."""
    b = 3
    q, k, v = _case(b, 1, h, hkv, dh, torch.bfloat16, seed=1)
    _, ck, cv = _case(b, s_max, h, hkv, dh, torch.bfloat16, seed=2)
    length = torch.tensor([0, 700, s_max + 3])
    cache = KVCache(ck.clone(), cv.clone(), length)
    out, new = attn._attend(q, k, v, rope_theta=0.0, window=0, kv_chunk=1024,
                            blocks_threshold=4096, use_pallas=False,
                            cache=cache, positions=None, cross=False,
                            causal=True, scale=scale)
    wk, wv = (_cache_write(c, x, length) for c, x in ((ck, k), (cv, v)))
    want = _model_route(q, wk, wv, length, threshold=4096, chunk=1024,
                        scale=scale)
    assert torch.equal(out, want)
    assert torch.equal(new.k, wk) and torch.equal(new.v, wv)
    assert torch.equal(new.length, length + 1)


def test_a_cpu_engine_stays_eager():
    """The engine replays no graph on the CPU, and a decode graph refuses
    a cache off the card. The engine runs on a private runtime, whose
    token deadlines no other test's admission reads."""
    cfg = smoke_config("granite-moe-1b-a400m")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rt = TransferRuntime(workers=2)
    transfer = TransferEngine(TransferPolicy.kernel_level(), device="cpu",
                              runtime=rt)
    eng = ContinuousBatchingEngine(model, params, n_slots=2, max_seq=32,
                                   transfer=transfer)
    try:
        assert eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                                  max_new_tokens=4)).admitted
        eng.run_to_completion()
        assert eng.steps >= 3 and eng._graph is None
        with pytest.raises(ValueError, match="on the card"):
            lm.DecodeGraph(eng.cache)
    finally:
        eng.close()
        transfer.close()
        rt.close()
