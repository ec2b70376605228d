"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 [hf:stabilityai; hf]. head_dim 160."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, vocab=100352,
        n_heads=32, n_kv_heads=8, d_ff=13824,
        mlp="gated_silu", norm="ln", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="stablelm-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, d_ff=160, remat=False, attn_kv_chunk=64,
    )
