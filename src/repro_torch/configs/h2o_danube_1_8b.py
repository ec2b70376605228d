"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention
[arXiv:2401.16818; hf]. SWA window 4096 makes it sub-quadratic, so this
arch RUNS the long_500k cell."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b", family="dense",
        n_layers=24, d_model=2560, vocab=32000,
        n_heads=32, n_kv_heads=8, d_ff=6912, sliding_window=4096,
        mlp="gated_silu", norm="rms", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="danube-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=2, d_ff=128, sliding_window=32,
        remat=False, attn_kv_chunk=64,
    )
