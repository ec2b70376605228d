"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias [hf:Qwen; hf]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, vocab=151936,
        n_heads=16, n_kv_heads=2, d_ff=11008, qkv_bias=True,
        mlp="gated_silu", norm="rms", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="qwen-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, d_ff=128, remat=False, attn_kv_chunk=64,
    )
