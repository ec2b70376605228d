"""Kimi-Linear-48B-A3B-Instruct [linear_mla]: 27L d_model=2304; layers
repeat 3 Kimi Delta Attention : 1 latent attention (0-based latent layers
3, 7, 11, 15, 19, 23 and 26; the other 20 KDA). KDA: 32 heads of 128,
q / k / v each 4,096 wide through a causal depthwise conv of 4, the decay
and output gates low rank (128). Latent attention: 32 heads, no query
LoRA, c of 512, rope columns 64 wide but never rotated
(``mla_use_nope``), q/k 192 and v 128 a head. Layer 0 a dense gated-SiLU
MLP of 9,216; layers 1-26 256 experts of 1,024, top-8 by sigmoid score
plus a correction bias, weights renormalised and times 2.446, plus 1
shared expert of 1,024; RMSNorm eps 1e-5; vocab 163,840, untied; bf16
[hf:moonshotai/Kimi-Linear-48B-A3B-Instruct config.json; arXiv:2510.26692].

One card's share of a deployment over four H100s with the experts split
64 a card (expert parallel over 4; attention, KDA, the dense layer, the
shared expert and the vocabulary replicated): this card holds experts 0-63
of each MoE layer (``experts_held``), routes over all 256 and computes its
own experts' part, with no exchange. Dropless: ``capacity_factor`` 64/8 =
held experts / top-k seats every token. Prompts prefill in chunks of
4,096 (the last one shorter), KDA's state and conv tails carried between
them; latent attention's prefill takes the flash kernel's two-width entry
(K 192, V 128) on the card."""

from repro_torch.models.config import ModelConfig

LAYER_TYPES = tuple("mla" if i % 4 == 3 or i == 26 else "kda"
                    for i in range(27))


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-linear-48b-a3b-instruct", family="linear_mla",
        n_layers=27, d_model=2304, vocab=163840, n_heads=32, n_kv_heads=32,
        rope_theta=10_000.0, layer_types=LAYER_TYPES,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, mla_nope=True,
        kda_heads=32, kda_head_dim=128, kda_conv_width=4, kda_gate_rank=128,
        d_ff=9216, first_k_dense=1,
        n_experts=256, top_k=8, n_shared_experts=1, d_expert=1024,
        experts_held=64, expert_offset=0, capacity_factor=64 / 8,
        moe_score="sigmoid", moe_routed_scale=2.446, moe_renormalize=True,
        norm_eps=1e-5, prefill_chunk=4096, use_pallas_attention=True,
        mlp="gated_silu", norm="rms",
    )


def smoke_config() -> ModelConfig:
    """Five layers, the dense one and a whole 3:1 period, at small widths
    (KDA heads of 16, 16 experts of which 8 held, top-4)."""
    return config().replace(
        name="kimi-linear-48b-a3b-instruct-smoke", n_layers=5,
        layer_types=("kda", "kda", "kda", "mla", "kda"), d_model=64,
        vocab=512, n_heads=4, n_kv_heads=4, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        kda_heads=4, kda_head_dim=16, kda_gate_rank=16, d_ff=96,
        n_experts=16, top_k=4, d_expert=16, experts_held=8, expert_offset=4,
        capacity_factor=8 / 4, prefill_chunk=16, remat=False,
        attn_kv_chunk=16, attn_blocks_threshold=24, moe_ragged_tokens=8,
    )
