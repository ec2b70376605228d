"""seamless-m4t-medium [audio]: enc-dec multimodal backbone.

12L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].
The speech frontend (conformer feature extractor) is a STUB per the
assignment: input_specs supplies precomputed frame embeddings. Adaptation
note (DESIGN.md): original uses learned positions; we use RoPE on the
decoder self-attention (TPU-idiomatic, no semantic impact for perf study).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, n_enc_layers=12, d_model=1024, vocab=256206,
        n_heads=16, n_kv_heads=16, d_ff=4096,
        mlp="gelu", norm="ln", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="seamless-smoke", n_layers=2, n_enc_layers=2, d_model=64,
        vocab=512, n_heads=4, n_kv_heads=4, d_ff=128, remat=False,
        attn_kv_chunk=64,
    )
