"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 stack + ONE shared attention block
(width 2*d_model) applied every 6 mamba layers with per-application LoRA
(r=128) [arXiv:2411.15242; hf]. SSM state is O(1) => runs long_500k."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, vocab=32000,
        n_heads=32, n_kv_heads=32, d_ff=8192,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        hybrid_attn_every=6, hybrid_lora_rank=128,
        micro_override=16,
        mlp="gated_silu", norm="rms", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="zamba2-smoke", n_layers=5, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, d_ff=128, ssm_state=16, ssm_head_dim=16,
        ssm_chunk=16, hybrid_attn_every=2, hybrid_lora_rank=8,
        remat=False, attn_kv_chunk=64,
    )
