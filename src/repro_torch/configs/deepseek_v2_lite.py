"""DeepSeek-V2-Lite [mla]: 27L d_model=2048, 16 heads of multi-head latent
attention with no query LoRA (kv_lora_rank 512, qk_nope 128, qk_rope 64,
v 128), YaRN RoPE (theta 10,000, factor 40 over 4,096 original positions,
beta_fast 32, beta_slow 1, mscale = mscale_all_dim = 0.707; 163,840
positions); layer 0 a dense gated-SiLU MLP of 10,944, layers 1-26 a MoE of
64 experts of 1,408, softmax top-6 not renormalised, plus 2 shared experts
of 1,408; RMSNorm eps 1e-6; vocab 102,400, untied; bf16
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434].

The two shared experts are the MoE's ``n_shared_experts = 2`` of width
1,408: one gated MLP of width 2,816, as published. Dropless routing:
``capacity_factor`` 64/6 = experts / top-k seats every token; from 256
tokens on (a prefill chunk) each expert runs over its own seats alone, and
a decode step's 64 experts over the padded buffer, which a CUDA graph
replays. Prompts prefill in chunks of 4,096 (the last one shorter), which
bounds the MoE's transients, and attend through the flash kernel's
two-width entry (K 192, V 128) on the card."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite", family="mla",
        n_layers=27, d_model=2048, vocab=102400, n_heads=16,
        n_kv_heads=16, rope_theta=10_000.0,
        kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128,
        yarn_factor=40.0, yarn_original_max_pos=4096, yarn_beta_fast=32.0,
        yarn_beta_slow=1.0, yarn_mscale=0.707,
        d_ff=10944, first_k_dense=1,
        n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
        capacity_factor=64 / 6, moe_renormalize=False,
        norm_eps=1e-6, prefill_chunk=4096, use_pallas_attention=True,
        mlp="gated_silu", norm="rms",
    )


def smoke_config() -> ModelConfig:
    """Three layers, one dense and two MoE, at small widths (the latent
    and head widths cut in proportion, YaRN as published)."""
    return config().replace(
        name="deepseek-v2-lite-smoke", n_layers=3, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, d_ff=96, n_experts=8, top_k=3,
        n_shared_experts=2, d_expert=16, capacity_factor=8 / 3,
        prefill_chunk=16, remat=False, attn_kv_chunk=16,
        attn_blocks_threshold=24, moe_ragged_tokens=8,
    )
