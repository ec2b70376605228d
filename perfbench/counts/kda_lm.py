"""The port's KDA kernels (``kernels/kda``) on a Kimi-Linear LM's KDA
layers: the operations and the bytes their launches need, from the
chunkwise algorithm at chunk C = 64 (``ref.kda_chunk_ref``), whatever
tiling the kernels use, over the program's counters.

A prefill call of S tokens over H heads of width d (keys and values
alike) runs S / C chunks a head. A chunk's work, a head, with P = C (C +
1) / 2 causal pairs:

- A and M, the decayed dot products of every pair: the decay times k_s
  (1 a channel), k_t's and q_t's multiply-adds (2 each): 5 P d, the
  exponentials left out;
- the forward substitution (I + A) X = [beta Gamma K | beta V]: a
  multiply-add a pair below the diagonal and column, C (C - 1) / 2 x 2d x
  2;
- the pass between chunks: U = U0 - W S, O = (Gamma Q) S + M U and S <-
  Gamma_C S + (K exp(G_C - G))^T U: 2 C d^2 three times, 2 P d and d^2.

Its bytes are what the call reads and writes whatever the kernels keep
in between: q, k and v (bf16) and g (f32) a token, beta (f32) a token and
head, o (bf16) a token, and the state read and written once a call (f32,
H d^2). A decode-step call reads and writes each slot's state once (f32)
and reads q, k, v (bf16), g (f32) and beta a slot and head, writing o
(bf16); its products a slot and head: the decay, u = k . S, the update
and o = q . S, 7 d^2. Each byte is counted once; the least time they give
is a floor."""

from __future__ import annotations

CHUNK = 64
BF16, F32 = 2, 4


def _heads(cfg: dict) -> tuple[int, int]:
    lac = cfg["linear_attn_config"]
    return lac["num_heads"], lac["head_dim"]


def chunk_prefill(cfg: dict, tokens: int, calls: int) -> tuple[float, int]:
    """(FLOPs, bytes) of ``calls`` prefill calls that took ``tokens``
    tokens in all (a call's last chunk counted by its tokens)."""
    h, d = _heads(cfg)
    c = CHUNK
    pairs = c * (c + 1) // 2
    per_chunk = (5 * pairs * d + c * (c - 1) * 2 * d
                 + 3 * 2 * c * d * d + 2 * pairs * d + d * d)
    flops = tokens / c * h * per_chunk
    nbytes = (tokens * h * (3 * d * BF16 + d * F32 + F32 + d * BF16)
              + calls * 2 * h * d * d * F32)
    return flops, nbytes


def decode_step(cfg: dict, calls: int, slots: int) -> tuple[int, int]:
    """(FLOPs, bytes) of ``calls`` decode-step calls over ``slots``
    slots."""
    h, d = _heads(cfg)
    cells = calls * slots * h
    flops = cells * 7 * d * d
    nbytes = cells * (2 * d * d * F32 + 3 * d * BF16 + d * F32 + F32
                      + d * BF16)
    return flops, nbytes
