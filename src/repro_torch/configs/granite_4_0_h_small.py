"""granite-4.0-h-small [hybrid_moe]: 40L d_model=4096, Mamba2 and GQA
mixers in the pattern ``layer_types`` (per 10 layers: 5 Mamba2, 1
attention, 4 Mamba2; 36 and 4 in all), each followed by a MoE of 72
experts top-10 (d_expert=768) plus a shared gated MLP of width 1,536;
Mamba2: expand 2, 128 heads of dim 64, d_state 128, 1 group, conv 4, chunk
256; attention: 32H (GQA kv=8) of dim 128, no position embedding; vocab
100,352, tied [hf:ibm-granite/granite-4.0-h-small config.json].

The shared MLP is the MoE's ``n_shared_experts = 2`` of width 768: two
gated MLPs of width 768, summed, are one of width 1,536 (their gate and up
columns side by side). RoPE off (``rope_theta = 0``): NoPE, as published.
The scalar multipliers (embedding 12, residual 0.22, attention 1/128,
logits / 16) and the norms' eps 1e-5 are the published ones. Dropless
routing: ``capacity_factor`` 7.2 = experts / top-k seats every token."""

from repro_torch.models.config import ModelConfig

PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small", family="hybrid_moe",
        n_layers=40, d_model=4096, vocab=100352,
        n_heads=32, n_kv_heads=8, rope_theta=0.0,
        d_ff=768, n_experts=72, top_k=10, n_shared_experts=2, d_expert=768,
        capacity_factor=7.2, tie_embeddings=True,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        ssm_conv_width=4, ssm_groups=1,
        layer_types=PERIOD * 4,
        embedding_multiplier=12.0, residual_multiplier=0.22,
        attention_multiplier=1.0 / 128, logits_scaling=16.0, norm_eps=1e-5,
        mlp="gated_silu", norm="rms",
    )


def smoke_config() -> ModelConfig:
    """Two layers, one Mamba2 and one attention, at small widths."""
    return config().replace(
        name="granite-4.0-h-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, d_ff=16, n_experts=8, top_k=2,
        d_expert=16, capacity_factor=4.0, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, layer_types=("mamba", "attention"),
        attention_multiplier=1.0 / 16, remat=False, attn_kv_chunk=64,
    )
