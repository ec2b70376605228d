"""The port's SSD kernels (``kernels/ssd_scan``) on a hybrid LM's Mamba2
layers: the operations and the bytes their launches need, from the padded
tokens they took (the program's counter ``ssm.scan_tokens``, summed over
layers) and the number of scans (one a layer a prefill).

A scan of S padded tokens (a multiple of the chunk Q) launches the
intra-chunk kernel and the state pass once each over S / Q chunks:

- the intra-chunk kernel reads x [S, H, P] and B, C [S, G, N] in the
  model's type and dt [S, H] in f32, and writes its diagonal output [S,
  H, P], the chunks' states [S / Q, H, P, N] and decays [S / Q, H], f32.
  Its products, a chunk, counted over the causal lower triangle only
  (Q (Q + 1) / 2 pairs): C.B a group, 2 Q(Q+1)/2 N; the diagonal output a
  head, 2 Q(Q+1)/2 P; the chunk's state a head, 2 Q P N;
- the state pass reads the chunks' states and decays and the initial
  state [H, P, N], and writes the state entering each chunk and the final
  one, f32; a multiply and an add an element of a chunk's state.

Each byte is counted once, however often a kernel reads it, and the decay
exponentials are left out: the counts are what the work needs, so the
least time they give is a floor."""

from __future__ import annotations

F32 = 4


def _shape(cfg: dict) -> tuple[int, int, int, int, int, int]:
    item = 2 if cfg["dtype"] in ("bfloat16", "float16") else F32
    return (cfg["mamba_chunk_size"], cfg["mamba_n_heads"],
            cfg["mamba_d_head"], cfg["mamba_n_groups"],
            cfg["mamba_d_state"], item)


def intra_chunk(cfg: dict, tokens: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the intra-chunk launches over ``tokens`` padded
    tokens."""
    q, h, p, g, n, item = _shape(cfg)
    chunks = tokens // q
    tri = q * (q + 1) // 2
    flops = chunks * (g * 2 * tri * n + h * (2 * tri * p + 2 * q * p * n))
    nbytes = (tokens * (h * p * item + 2 * g * n * item + h * F32
                        + h * p * F32)
              + chunks * (h * p * n * F32 + h * F32))
    return flops, nbytes


def state_pass(cfg: dict, tokens: int, scans: int) -> tuple[int, int]:
    """(FLOPs, bytes) of the state-pass launches over ``tokens`` padded
    tokens in ``scans`` scans."""
    q, h, p, _g, n, _item = _shape(cfg)
    chunks = tokens // q
    state = h * p * n * F32
    flops = chunks * 2 * h * p * n
    nbytes = chunks * (2 * state + h * F32) + scans * 2 * state
    return flops, nbytes
