"""The port's latent decode kernel (``kernels/decode_attention``, entry
``mla_decode``) on a DeepSeek-V2 LM's decode steps: the operations and the
bytes its launches need, from the live rows they read (the program's
``attn.latent_rows`` counter, summed over slots and layers) and the
number of calls (``attn.decode_latent``, one a layer a step).

A call reads each live latent row once, c then k^R (``kv_lora_rank +
qk_rope_head_dim`` bf16 values), and each slot's query row a head (the
same width) and writes its output row a head (``kv_lora_rank`` values).
Its products, a row: the scores, 2 H (r + dr) FLOPs, and the weighted sum
of the values, 2 H r. The partials between the split and the merge
launches, and the softmax's exponentials, are left out: the counts are
what the work needs, so the least time they give is a floor."""

from __future__ import annotations

BF16 = 2


def latent_decode(cfg: dict, rows: int, calls: int,
                  slots: int) -> tuple[int, int]:
    """(FLOPs, bytes) of ``calls`` latent decode calls over ``slots``
    slots that read ``rows`` live rows in all."""
    h, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    width = r + cfg["qk_rope_head_dim"]
    flops = rows * h * (width + r) * 2
    nbytes = (rows * width + calls * slots * h * (width + r)) * BF16
    return flops, nbytes
