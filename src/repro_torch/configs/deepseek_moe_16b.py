"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400,
fine-grained MoE: 64 routed experts top-6 + 2 shared, d_expert=1408
[arXiv:2401.06066; hf].

Simplification (noted in DESIGN.md): the real model's layer 0 is a dense
FFN; we keep all 28 layers MoE so the stack is scan-homogeneous (changes
<2% of params, none of the routing/transfer behaviour under study)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        n_layers=28, d_model=2048, vocab=102400,
        n_heads=16, n_kv_heads=16, d_ff=1408,
        n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
        prefill_chunk=8192,  # §Perf B5: bounds MoE dispatch temp to <16GiB HBM
        mlp="gated_silu", norm="rms", rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        name="deepseek-smoke", n_layers=2, d_model=64, vocab=512,
        n_heads=4, n_kv_heads=4, d_ff=64, n_experts=8, top_k=2,
        n_shared_experts=1, d_expert=64, remat=False, attn_kv_chunk=64,
    )
