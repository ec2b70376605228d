"""internlm2-20b [dense]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297; hf]."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-20b", family="dense",
        n_layers=48, d_model=6144, vocab=92544,
        n_heads=48, n_kv_heads=8, d_ff=16384,
        mlp="gated_silu", norm="rms", rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="internlm2-smoke", n_layers=2, d_model=96, vocab=512,
        n_heads=6, n_kv_heads=2, d_ff=192, remat=False, attn_kv_chunk=64,
    )
