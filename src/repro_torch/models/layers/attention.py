"""Attention: GQA + RoPE + sliding window + KV cache + blocks-mode chunking.

The paper's Unique/Blocks partitioning shows up here as ``kv_chunk``: full
(unique) attention materialises the [S_q, S_kv] score block; blocks-mode
streams the KV sequence in chunks with an online-softmax accumulator
(flash-attention structure) so the working set is O(S_q x chunk). The
hand-written kernel in ``repro_torch.kernels.flash_attention`` runs the same
schedule on the card; ``attn_apply`` sends self-attention there under the
reference's exact conditions (``use_pallas`` on, no cache, self-attention).

Scores are taken in float32 (the reference's
``preferred_element_type=float32``: the operands are cast up first, so bf16
products are exact) and probabilities are cast to q's type before the PV
product, in every path.

The KV cache is updated IN PLACE (``_cache_write``): the reference donates
its cache and gets an updated copy back; here the returned cache holds the
same tensors as the one passed in. One new token a slot against the cache,
on the card, takes the hand-written decode kernel
(``repro_torch.kernels.decode_attention``) where :func:`_decode_route`
says so: it reads each slot's live rows where they lie, with no repeat of
K / V and no f32 copy. A cache ``length`` is a Python int when
every slot holds the same number of tokens (the host knows it, so slicing
at it needs no device sync), a 0-d tensor, or a [B] int tensor of per-slot
lengths (continuous batching)."""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import contract_on_data, is_dtensor
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.layers.rope import apply_rope
from repro_torch.utils import trace

NEG_INF = -2.0**30  # large-but-finite; avoids NaN from (-inf) - (-inf)
_INV_LN2 = 1.4426950408889634

Length = Union[int, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.dim() == 0


def _cache_write(dst: torch.Tensor, new: torch.Tensor,
                 length: Length) -> torch.Tensor:
    """Write ``new`` [B, s, Hkv, Dh] into ``dst`` [B, S_max, Hkv, Dh] at
    position ``length`` (scalar, or [B] per-slot lengths), in place; returns
    ``dst``. A scalar start is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it. With [B] lengths, a row whose
    column falls past S_max is dropped, as the reference's scatter drops
    it (an idle continuous-batching slot keeps growing past S_max); so is
    one before column 0 (a negative start: a write into one shard of a
    cache split on its sequence, whose columns start past the write).

    The drop takes no host sync (decode writes every layer): each column
    is clamped into [0, S_max - 1] and written with the value that
    position must end with — this call's row for it where the call covers
    it, else what ``dst`` holds there — so every write a clamp sends to
    the first or last position carries the same value, and that position
    keeps its old value unless this call covers it."""
    new = new.to(dst.dtype)
    s = new.shape[1]
    if isinstance(length, int):
        start = min(max(length, 0), dst.shape[1] - s)
        dst[:, start:start + s] = new
        return dst
    length = length.to(dst.device)
    steps = torch.arange(s, device=dst.device)
    if length.dim() == 0:
        start = length.clamp(0, dst.shape[1] - s)
        dst.index_copy_(1, start + steps, new)
        return dst
    length = length.long()
    rows = torch.arange(new.shape[0], device=dst.device)[:, None]  # [B,1]
    cols = (length[:, None] + steps[None, :]).clamp(0, dst.shape[1] - 1)
    src = cols - length[:, None]  # the row of ``new`` that covers cols
    covered = ((src >= 0) & (src < s))[..., None, None]
    src = src.clamp(0, s - 1)[..., None, None].expand(-1, -1, *new.shape[2:])
    dst[rows, cols] = torch.where(covered, new.gather(1, src), dst[rows, cols])
    return dst


class KVCache(NamedTuple):
    """Preallocated decode cache for one layer (or, stacked, for all).

    k, v: [(L,) B, S_max, Hkv, Dh]; length: tokens already cached (see the
    module docstring)."""

    k: torch.Tensor
    v: torch.Tensor
    length: Length

    @staticmethod
    def zeros(batch: int, s_max: int, n_kv: int, dh: int,
              dtype: torch.dtype, device=None) -> "KVCache":
        shape = (batch, s_max, n_kv, dh)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device), 0)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, Dh] -> [B, S, Hkv*n_rep, Dh]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _all_scalar(*xs) -> bool:
    return all(x is None or _is_scalar(x) for x in xs)


def _as_vec(x):
    """Scalar or [B] -> broadcastable against [B?,s_q,s_kv]. A Python int
    stays an int: adding it to a device tensor needs no host-to-device copy
    (a copy from pageable memory would wait for the device each layer)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1, 1, 1)
    return x


def _ok_mask(s_q: int, s_kv: int, q_offset, *, causal: bool, window: int,
             kv_start=0, kv_valid=None, device=None) -> torch.Tensor:
    """Bool mask [B?, s_q, s_kv]; q_offset / kv_valid may be scalars or [B]
    (per-slot cache lengths — continuous batching)."""
    qpos = (torch.arange(s_q, device=device)[None, :, None]
            + _as_vec(q_offset))  # [B?,sq,1]
    kpos = (torch.arange(s_kv, device=device)[None, None, :]
            + _as_vec(kv_start))  # [B?,1,skv]
    ok = torch.ones((1, s_q, s_kv), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    if kv_valid is not None:
        ok = ok & (kpos < _as_vec(kv_valid))
    return ok


def _mask_bias(s_q: int, s_kv: int, q_offset, *, causal: bool, window: int,
               kv_start=0, device=None) -> torch.Tensor:
    """[s_q, s_kv] additive f32 bias (scalar-offset fast path)."""
    ok = _ok_mask(s_q, s_kv, q_offset, causal=causal, window=window,
                  kv_start=kv_start, device=device)[0]
    return torch.where(ok, 0.0, NEG_INF).float()


def attention_unique(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     q_offset: Length = 0, kv_valid: Length | None = None,
                     kv_offset: Length = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Unique-mode attention: one [S_q, S_kv] score block.

    q: [B, S_q, H, Dh]; k, v: [B, S_kv, Hkv, Dh] (Hkv divides H; v's Dh
    may differ). kv_valid: kv positions >= kv_valid are masked (cache).
    ``scale`` multiplies the scores (None: 1/sqrt(Dh)). While a
    profiler records, the repeat of K / V over each head group and K's
    cast to f32 are a span named ``attn.cache``."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    dev = q.device
    with trace.span("attn.cache"):  # K / V to every head of a group; K in f32
        k = repeat_kv(k, h // hkv).float()
        v = repeat_kv(v, h // hkv)
    scale = _scale(scale, dh)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k)
    if _all_scalar(q_offset, kv_offset, kv_valid):
        bias = _mask_bias(sq, k.shape[1], q_offset, causal=causal,
                          window=window, kv_start=kv_offset, device=dev)
        scores = scores * scale + bias
        if kv_valid is not None:
            kpos_v = torch.arange(k.shape[1], device=dev) + kv_offset
            scores = torch.where(kpos_v[None, None, None, :] < kv_valid,
                                 scores, NEG_INF)
    else:
        ok = _ok_mask(sq, k.shape[1], q_offset, causal=causal, window=window,
                      kv_start=kv_offset, kv_valid=kv_valid, device=dev)
        scores = torch.where(ok[:, None], scores * scale, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     q_offset: Length = 0, kv_valid: Length | None = None,
                     kv_chunk: int = 1024,
                     kv_offset: Length = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Blocks-mode attention: stream KV in chunks with online softmax.

    Same semantics as :func:`attention_unique` (v's head dim may differ
    from q's and k's); working set O(S_q * kv_chunk). This is the paper's
    BLOCKS partitioning applied to the KV stream."""
    b, sq, h, dh = q.shape
    s_kv = k.shape[1]
    hkv = k.shape[2]
    dev = q.device
    if s_kv % kv_chunk:
        # pad kv to a chunk multiple; padded tail masked via kv_valid
        pad = kv_chunk - s_kv % kv_chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_valid = s_kv if kv_valid is None else kv_valid
        s_kv = k.shape[1]
    n_chunks = s_kv // kv_chunk
    scale = _scale(scale, dh)
    n_rep = h // hkv
    qf = q.float()

    acc = torch.zeros((b, h, sq, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        sl = slice(ci * kv_chunk, (ci + 1) * kv_chunk)
        kcb = repeat_kv(k[:, sl], n_rep)
        vcb = repeat_kv(v[:, sl], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kcb.float()) * scale
        if _all_scalar(q_offset, kv_offset) and kv_valid is None:
            s = s + _mask_bias(sq, kv_chunk, q_offset, causal=causal,
                               window=window,
                               kv_start=ci * kv_chunk + kv_offset, device=dev)
        else:
            ok = _ok_mask(sq, kv_chunk, q_offset, causal=causal,
                          window=window, kv_start=ci * kv_chunk + kv_offset,
                          kv_valid=kv_valid, device=dev)
            s = torch.where(ok[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * _INV_LN2)
        p = torch.exp2((s - m_new[..., None]) * _INV_LN2)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vcb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, Sq, H, Dh]


def attention(q, k, v, *, causal=True, window=0, q_offset=0, kv_valid=None,
              kv_chunk: int = 1024, blocks_threshold: int = 4096,
              kv_offset: Length = 0, scale: float | None = None
              ) -> torch.Tensor:
    """Policy dispatch: Unique mode below the threshold, Blocks above.

    kv_offset: absolute position of k[:, 0] (nonzero when the cache read was
    sliced, e.g. sliding-window decode)."""
    if k.shape[1] <= blocks_threshold:
        return attention_unique(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, kv_valid=kv_valid,
                                kv_offset=kv_offset, scale=scale)
    return attention_blocks(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_valid=kv_valid,
                            kv_chunk=kv_chunk, kv_offset=kv_offset,
                            scale=scale)


def _scale(scale: float | None, dh: int) -> float:
    """The scores' scale: the configuration's, else 1/sqrt(Dh)."""
    return 1.0 / math.sqrt(dh) if scale is None else scale


# ---------------------------------------------------------------------------
# Full attention block (params + apply)
# ---------------------------------------------------------------------------

def attn_params(generator: torch.Generator, d_model: int, n_heads: int,
                n_kv: int, head_dim: int, *, bias: bool, dtype: torch.dtype,
                device=None) -> dict:
    """Normal projections with the reference's scales (drawn on the
    generator's device), zero biases."""
    sd = 1.0 / math.sqrt(d_model)
    g_dev = generator.device

    def draw(shape, scale):
        w = torch.randn(shape, generator=generator, device=g_dev) * scale
        return w.to(device, dtype)

    p = {
        "wq": draw((d_model, n_heads * head_dim), sd),
        "wk": draw((d_model, n_kv * head_dim), sd),
        "wv": draw((d_model, n_kv * head_dim), sd),
        "wo": draw((n_heads * head_dim, d_model), sd / math.sqrt(2.0)),
    }
    if bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def attn_apply(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
               head_dim: int, rope_theta: float, window: int = 0,
               kv_chunk: int = 1024, blocks_threshold: int = 4096,
               use_pallas: bool = False,
               cache: KVCache | None = None,
               positions: torch.Tensor | None = None,
               xk: torch.Tensor | None = None,
               causal: bool = True,
               scale: float | None = None
               ) -> tuple[torch.Tensor, KVCache | None]:
    """Self- (xk=None) or cross- (xk=encoder output) attention.

    With a cache: writes this call's K/V at cache.length (in place) and
    attends over the valid prefix (decode path). positions: [S] absolute
    positions for RoPE (defaults to arange, offset by cache.length when
    decoding). ``scale`` multiplies the scores on every route (None:
    1/sqrt(head_dim)). ``use_pallas`` sends self-attention without a cache
    to the flash kernel, which scales by 1/sqrt(head_dim): another
    ``scale`` is folded into q first.
    Projections that come out as ``DTensor``s take :func:`_sharded_attn`;
    rows replicated on the data axes (B = 1) split each projection's
    contraction over them (``contract_on_data``)."""
    b, s, _ = x.shape
    src = x if xk is None else xk
    qf = contract_on_data(x, p["wq"]) + p.get("bq", 0)
    kf = contract_on_data(src, p["wk"]) + p.get("bk", 0)
    vf = contract_on_data(src, p["wv"]) + p.get("bv", 0)
    kw = dict(rope_theta=rope_theta, window=window, kv_chunk=kv_chunk,
              blocks_threshold=blocks_threshold, use_pallas=use_pallas,
              cache=cache, positions=positions, cross=xk is not None,
              causal=causal, scale=scale)
    o, new_cache = attend_projected(qf, kf, vf, n_heads=n_heads, n_kv=n_kv,
                                    head_dim=head_dim, **kw)
    return contract_on_data(o.reshape(b, s, n_heads * head_dim),
                            p["wo"]), new_cache


def attend_projected(qf, kf, vf, *, n_heads: int, n_kv: int, head_dim: int,
                     **kw) -> tuple[torch.Tensor, KVCache | None]:
    """Attention from projections q [B, S, H x Dh], k / v [B, S_kv, Hkv x
    Dh] (None for cross-attention against a cache, which holds them):
    (out [B, S, H, Dh], new cache); ``kw`` as :func:`_attend`'s.
    ``DTensor`` projections take :func:`_sharded_attn`."""
    if any(is_dtensor(t) for t in (qf, kf, vf)):
        return _sharded_attn(qf, kf, vf, n_heads, n_kv, head_dim, **kw)
    b, s = qf.shape[:2]
    k, v = ((None, None) if kf is None else
            (t.reshape(b, t.shape[1], n_kv, head_dim) for t in (kf, vf)))
    return _attend(qf.reshape(b, s, n_heads, head_dim), k, v, **kw)


def _positions(offset: Length, s: int, device) -> torch.Tensor:
    """The absolute positions of ``s`` new tokens after ``offset`` cached
    ones: [s] for a scalar offset, [B, s] for per-slot lengths."""
    steps = torch.arange(s, device=device)
    if _is_scalar(offset):
        return steps + offset
    return steps[None] + offset.to(device).reshape(-1, 1)


def _decode_route(q: torch.Tensor, ck: torch.Tensor, *, window: int,
                  kv_heads: torch.Tensor | None) -> bool:
    """Whether self-attention against the cache ``ck`` (after this call's
    write) takes the decode kernel: one query token a slot, plain CUDA
    tensors, no window, the q heads grouped over the cache's as
    :func:`repeat_kv` groups them (no ``kv_heads``), and dtypes and widths
    the kernel is built for (``decode_attention.kernel.fits``). Every
    other call keeps the plain routes."""
    return (q.shape[1] == 1 and window == 0 and kv_heads is None
            and q.device.type == "cuda"
            and not (is_dtensor(q) or is_dtensor(ck))
            and decode_kernel.fits(q, ck))


def _attend(q, k, v, *, rope_theta: float, window: int, kv_chunk: int,
            blocks_threshold: int, use_pallas: bool, cache: KVCache | None,
            positions, cross: bool, causal: bool,
            kv_heads: torch.Tensor | None = None,
            scale: float | None = None):
    """``attn_apply`` after the projections: q [B, S, H, Dh], k / v [B,
    S_kv, Hkv, Dh] -> (out [B, S, H, Dh], new cache). ``kv_heads``, where
    given, is the K/V head each q head reads (a head-sharded q against
    K/V its shard does not split the same way); after the cache write."""
    b, s = q.shape[:2]
    dev = q.device
    offset = cache.length if cache is not None else 0
    if positions is None:
        positions = _positions(offset, s, dev)
    if rope_theta > 0 and not cross:  # no rope on cross-attention
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions if k.shape[1] == s
                       else torch.arange(k.shape[1], device=dev),
                       rope_theta)

    if use_pallas and cache is None and not cross and s == k.shape[1]:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        if scale is not None:  # the kernel takes 1/sqrt(Dh); the rest in q
            q = q * (scale * math.sqrt(q.shape[-1]))
        return flash_attention(q, k, v, causal=causal, window=window), None

    def select(k, v):
        if kv_heads is None:
            return k, v
        return k.index_select(2, kv_heads), v.index_select(2, kv_heads)

    new_cache = None
    if cache is not None and not cross:
        ck = _cache_write(cache.k, k, cache.length)
        cv = _cache_write(cache.v, v, cache.length)
        new_cache = KVCache(ck, cv, cache.length + s)
        if _decode_route(q, ck, window=window, kv_heads=kv_heads):
            return decode_attention(q, ck, cv, cache.length,
                                    scale=scale), new_cache
        k, v = ck, cv
        kv_off: Length = 0
        if window > 0 and ck.shape[1] > 2 * window and _is_scalar(cache.length):
            # sliding-window decode only ever attends the last `window`
            # positions: slice the cache read. An int length slices on the
            # host; a tensor length gathers on the device (no sync).
            w_eff = min(_round_up(window + s, 128), ck.shape[1])
            hi = ck.shape[1] - w_eff
            if isinstance(cache.length, int):
                start = min(max(cache.length + s - w_eff, 0), hi)
                k, v = ck[:, start:start + w_eff], cv[:, start:start + w_eff]
            else:
                start = (cache.length + s - w_eff).clamp(0, hi)
                idx = start + torch.arange(w_eff, device=dev)
                k, v = ck.index_select(1, idx), cv.index_select(1, idx)
            kv_off = start
        k, v = select(k, v)
        out = attention(q, k, v, causal=causal, window=window, q_offset=offset,
                        kv_valid=cache.length + s, kv_chunk=kv_chunk,
                        blocks_threshold=blocks_threshold, kv_offset=kv_off,
                        scale=scale)
    elif cache is not None:  # cross-attn with precomputed encoder cache
        k, v = select(cache.k, cache.v)
        out = attention(q, k, v, causal=False,
                        kv_valid=cache.length, kv_chunk=kv_chunk,
                        blocks_threshold=blocks_threshold, scale=scale)
        new_cache = cache
    else:
        k, v = select(k, v)
        out = attention(q, k, v, causal=causal, window=window,
                        kv_chunk=kv_chunk, blocks_threshold=blocks_threshold,
                        scale=scale)
    return out, new_cache


def _sharded_attn(qf, kf, vf, n_heads: int, n_kv: int, head_dim: int, *,
                  cache: KVCache | None, positions, use_pallas: bool,
                  cross: bool, **kw):
    """:func:`_attend` over ``DTensor`` projections ([B, S, heads x Dh]).

    DTensor can neither split a sharded feature dim inside a head (the
    rules shard ``wk``'s 256 columns 16 ways for qwen's 2 KV heads) nor
    run the products that merge a batch and a head dim sharded on two
    mesh dims. So q, k and v are redistributed to batch on the data axes
    and whole heads on "model" where the head count divides it (K / V take
    the cache's placements where there is one), and the attention runs on
    each rank's shards, as XLA's partitioner would place it; the cache's
    local shards are written in place. The output is q's placements
    again, for ``wo``'s product. A cache the rules shard on its sequence
    (the hybrid's one-layer [B, S_max, ...] cache) is read where it lies
    (:func:`_seq_sharded_attn`, :func:`_prefill_seq_cache`). A flash call
    refuses the ``DTensor``s, as every kernel wrapper does."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.sharding import local_shard, shard_placements
    from repro_torch.kernels._build import refuse_dtensor

    if use_pallas and cache is None and not cross:
        refuse_dtensor("flash_attention", qf, kf, vf)
    mesh = next(t.device_mesh for t in (qf, kf, vf) if is_dtensor(t))
    qf, kf, vf = (t if t is None or is_dtensor(t) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim) for t in (qf, kf, vf))
    b, s = qf.shape[:2]
    if (cache is not None and not cross and is_dtensor(cache.k)
            and any(pl.is_shard(1) for pl in cache.k.placements)):
        if (s > 1 and isinstance(cache.length, int) and cache.length == 0
                and positions is None):
            return _prefill_seq_cache(qf, kf, vf, n_heads, n_kv, head_dim,
                                      cache=cache, **kw)
        return _seq_sharded_attn(qf, kf, vf, n_heads, n_kv, head_dim,
                                 cache=cache, positions=positions, **kw)
    q_pl = shard_placements(mesh, b, {2: n_heads})
    # K / V on the cache's placements where there is one; on batch and
    # heads without
    if cache is None:
        kv_pl = shard_placements(mesh, b, {2: n_kv})
    elif is_dtensor(cache.k):
        kv_pl = cache.k.placements
    else:
        kv_pl = shard_placements(mesh, b)
    q, q_off = local_shard(qf, q_pl)
    q = q.reshape(q.shape[0], q.shape[1], -1, head_dim)
    k = v = None  # cross-attention against a cache: K/V are the cache's
    k_off = (0, 0, 0)
    if kf is not None:
        k, k_off = local_shard(kf, kv_pl)
        v, _ = local_shard(vf, kv_pl)
        k = k.reshape(k.shape[0], k.shape[1], -1, head_dim)
        v = v.reshape(v.shape[0], v.shape[1], -1, head_dim)
    rows = slice(q_off[0], q_off[0] + q.shape[0])  # this rank's batch rows

    def local(t, batch_dim: bool):
        if is_dtensor(t):
            t = t.full_tensor() if batch_dim else t.to_local()
        if batch_dim and isinstance(t, torch.Tensor) and t.dim() >= 1:
            return t[rows]
        return t

    lcache = None
    if cache is not None:
        lk, lv = ((c.to_local() if is_dtensor(c) else c[rows])
                  for c in (cache.k, cache.v))
        length = cache.length
        lcache = KVCache(lk, lv, local(length, not _is_scalar(length)))
    if positions is not None:
        positions = local(positions, positions.dim() == 2)
    h0, k0 = q_off[2] // head_dim, k_off[2] // head_dim
    h_l = q.shape[2]
    n_kv_l = (lcache.k if cache is not None and cross else k).shape[2]
    want = [(h0 + j) // (n_heads // n_kv) - k0 for j in range(h_l)]
    kv_heads = None  # None: repeat_kv's grouping is this shard's
    if h_l % n_kv_l or want != [j // (h_l // n_kv_l) for j in range(h_l)]:
        kv_heads = torch.tensor(want, device=q.device)
    out, new = _attend(q, k, v, cache=lcache, positions=positions,
                       use_pallas=False, cross=cross, kv_heads=kv_heads, **kw)
    out = DTensor.from_local(out, mesh, q_pl)
    if new is not None:
        new = KVCache(cache.k, cache.v,
                      cache.length if cross else cache.length + q.shape[1])
    return out, new


def _prefill_seq_cache(qf, kf, vf, n_heads: int, n_kv: int, head_dim: int,
                       *, cache: KVCache, **kw):
    """A prompt from position 0 into a cache the rules shard on its
    sequence: the attention runs over the new K/V on the batch rule's
    placements (into a fresh cache of the same length with the batch on
    the data axes, so the K/V are rotated, written and read as
    :func:`_attend` does on whole tensors), and only the new K/V are moved
    to the shards that hold their positions."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor import zeros as dzeros

    from repro_torch.dist.sharding import (
        rows_to_columns, shard_placements, shard_start)

    mesh = qf.device_mesh
    b, s = qf.shape[:2]
    s_max = cache.k.shape[1]
    kv_pl = shard_placements(mesh, b, {2: n_kv})
    fresh = KVCache(*(dzeros((b, s_max, n_kv, head_dim), dtype=cache.k.dtype,
                             device_mesh=mesh, placements=kv_pl)
                      for _ in range(2)), 0)
    out, new = _sharded_attn(qf, kf, vf, n_heads, n_kv, head_dim,
                             cache=fresh, positions=None, use_pallas=False,
                             cross=False, **kw)
    s0 = shard_start(cache.k, 1)
    seq = [i for i, pl in enumerate(cache.k.placements) if pl.is_shard(1)]
    for src, dst in ((new.k, cache.k), (new.v, cache.v)):
        if seq == [i for i, pl in enumerate(kv_pl) if pl.is_shard(0)]:
            # rows and positions on the same data axes: all-to-alls, then
            # the heads gathered over "model"
            src = DTensor.from_local(rows_to_columns(src.to_local(), mesh,
                                                     seq), mesh,
                                     [Shard(1) if i in seq else pl
                                      for i, pl in enumerate(kv_pl)])
        got = src.redistribute(mesh, dst.placements).to_local()
        n = max(0, min(s - s0, got.shape[1]))
        if n:
            dst.to_local()[:, :n] = got[:, :n]
    return out, KVCache(cache.k, cache.v, s)


def _block_attention(q, k, v, *, causal: bool, window: int, q_offset,
                     kv_offset, kv_valid, scale: float | None = None):
    """Attention of q [B, s, H, Dh] over one block of the keys [B,
    S_blk, Hkv, Dh] whose first position is ``kv_offset``, as
    :func:`attention_unique` takes it: (the output normalised over the
    block, in q's type; its log-sum-exp [B, s, H], f32). A row with no
    valid key in the block gets a log-sum-exp near ``NEG_INF``."""
    h, dh = q.shape[2], q.shape[3]
    k = repeat_kv(k, h // k.shape[2])
    v = repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * _scale(scale, dh)
    ok = _ok_mask(q.shape[1], k.shape[1], q_offset, causal=causal,
                  window=window, kv_start=kv_offset, kv_valid=kv_valid,
                  device=q.device)
    scores = torch.where(ok[:, None], scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", (p / l).to(q.dtype), v)
    return out, (m + torch.log(l))[..., 0].transpose(1, 2)


def _seq_sharded_attn(qf, kf, vf, n_heads: int, n_kv: int, head_dim: int,
                      *, cache: KVCache, positions, rope_theta: float,
                      window: int, causal: bool, scale: float | None = None,
                      **kw):
    """Attention against a cache the rules shard on its sequence (S_max on
    the data axes, replicated over "model"), read where it lies: each rank
    attends its slice of the positions for every row, for the heads its
    "model" rank takes where their count divides it; the partial outputs
    and their log-sum-exp are merged over the slices (a collective of [B,
    s, H/M, Dh + 1], never of the cache). The new K/V (every row's, every
    head's: the cache is whole over "model") go only into the slice that
    holds each row's position, per-slot lengths included; a scalar start
    is clamped so the write fits, as :func:`_cache_write` clamps it. The
    merge sums in another order than the whole cache's softmax (f32
    reach)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.dist.sharding import (
        model_split, shard_placements, shard_start)

    mesh = qf.device_mesh
    nd = mesh.ndim
    b, s = qf.shape[:2]
    m, split, h0, h_l = model_split(mesh, n_heads)
    heads = [Shard(2) if i == m and split else Replicate()
             for i in range(nd)]
    q = qf.redistribute(mesh, heads).to_local().reshape(b, s, h_l, head_dim)
    k, v = (t.redistribute(mesh, [Replicate()] * nd).to_local().reshape(
        b, s, n_kv, head_dim) for t in (kf, vf))
    length = cache.length
    if is_dtensor(length):
        length = length.full_tensor()
    if is_dtensor(positions):
        positions = positions.full_tensor()
    dev = q.device
    if positions is None:
        positions = _positions(length, s, dev)
    if rope_theta > 0:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    ck, cv = cache.k.to_local(), cache.v.to_local()
    s_l, s_max = ck.shape[1], cache.k.shape[1]
    s0 = shard_start(cache.k, 1)
    if isinstance(length, int):  # the part of the write in this shard
        start = min(max(length, 0), s_max - s)
        lo, hi = max(start, s0), min(start + s, s0 + s_l)
        if lo < hi:
            ck[:, lo - s0:hi - s0] = k[:, lo - start:hi - start].to(ck.dtype)
            cv[:, lo - s0:hi - s0] = v[:, lo - start:hi - start].to(cv.dtype)
    else:  # each row's start in this shard's columns; outside, dropped
        start = length.to(dev).long()
        if start.dim() == 0:
            start = start.clamp(0, s_max - s).expand(b)
        _cache_write(ck, k, start - s0)
        _cache_write(cv, v, start - s0)

    rep = n_heads // n_kv
    if h0 % rep == 0 and h_l % rep == 0:  # whole groups: a slice
        kk, vv = (c[:, :, h0 // rep:(h0 + h_l) // rep] for c in (ck, cv))
    else:
        idx = torch.tensor([(h0 + j) // rep for j in range(h_l)], device=dev)
        kk, vv = ck.index_select(2, idx), cv.index_select(2, idx)
    out, lse = _block_attention(q, kk, vv, causal=causal, window=window,
                                q_offset=length, kv_offset=s0,
                                kv_valid=length + s, scale=scale)
    seq = [i for i, pl in enumerate(cache.k.placements) if pl.is_shard(1)]
    on_model = [Shard(3) if i == m and split else Replicate()
                for i in range(nd)]
    part = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    every = DTensor.from_local(part, mesh, [
        Shard(0) if i in seq else q for i, q in enumerate(on_model)]
    ).redistribute(mesh, on_model).to_local()  # [slices, B, s, H/M, Dh+1]
    o_r, lse_r = every[..., :-1], every[..., -1:]
    w = torch.exp(lse_r - lse_r.amax(0, keepdim=True))
    out = ((w * o_r).sum(0) / w.sum(0)).to(q.dtype)
    out = DTensor.from_local(out, mesh, heads).redistribute(
        mesh, shard_placements(mesh, b, {2: n_heads}))
    return out, KVCache(cache.k, cache.v, cache.length + s)
