"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) vocab=49155,
32 experts top-8, d_expert=512 [hf:ibm-granite; hf]. Tied embeddings."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, vocab=49155,
        n_heads=16, n_kv_heads=8, d_ff=512,
        n_experts=32, top_k=8, n_shared_experts=0, d_expert=512,
        tie_embeddings=True,
        mlp="gated_silu", norm="rms", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="granite-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, d_ff=32, n_experts=4, top_k=2,
        d_expert=32, remat=False, attn_kv_chunk=64,
    )
