"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 [hf:mistralai/Pixtral-12B-2409; unverified].

Backbone only per the assignment: the pixtral ViT frontend is a STUB —
input_specs supplies precomputed patch embeddings [B, n_prefix, D] that are
prepended to the text sequence. head_dim=128 (mistral-nemo convention)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, vocab=131072,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        n_prefix_tokens=256,
        mlp="gated_silu", norm="rms", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="pixtral-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        n_prefix_tokens=8, remat=False, attn_kv_chunk=64,
    )
