"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified].
d_inner=3072, 48 SSD heads of dim 64. O(1) decode state => runs long_500k."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
        norm="rms",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="mamba2-smoke", n_layers=2, d_model=64, vocab=512,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=16, remat=False,
    )
