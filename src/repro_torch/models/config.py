"""Model configuration — one frozen dataclass covering every assigned family.

A copy of ``repro/models/config.py`` (the port imports nothing of the
reference package). Every field keeps its meaning except two:
``use_pallas_attention`` sends self-attention to the port's hand-written
flash kernel (``repro_torch.kernels.flash_attention``), and
``pallas_interpret`` means nothing here and stays for field parity.

Families:
- ``dense``  : decoder-only transformer (stablelm, qwen2.5, internlm2, h2o-danube)
- ``vlm``    : dense backbone + stub patch-embedding prefix (pixtral)
- ``audio``  : encoder-decoder + stub frame-embedding frontend (seamless-m4t)
- ``moe``    : mixture-of-experts FFN (deepseek-moe, granite-moe)
- ``ssm``    : attention-free Mamba2 / SSD (mamba2-780m)
- ``hybrid`` : Mamba2 backbone + shared attention blocks (zamba2)
- ``hybrid_moe``: Mamba2 and GQA mixers in a per-layer pattern
  (``layer_types``), each followed by a routed MoE with a shared expert
  (granite-4.0-h-small)
- ``mla``    : multi-head latent attention over a latent KV cache, with
  YaRN RoPE, leading dense layers and then MoE layers (DeepSeek-V2-Lite)
- ``linear_mla``: Kimi Delta Attention (a gated delta rule over a
  per-head matrix state) and latent attention without RoPE in a per-layer
  pattern (``layer_types`` "kda" / "mla"), a leading dense layer, then
  sigmoid-routed MoE layers that may hold a share of the experts
  (Kimi-Linear)

The fields below ``layer_types`` (the published scalar multipliers and
the norms' eps) are set by the ``hybrid_moe`` configs alone, and those
below ``kv_lora_rank`` (the latent attention's widths, YaRN, the leading
dense layers, routing without renormalisation) by the ``mla`` configs
alone, and those below ``kda_heads`` (KDA's widths, latent attention
without RoPE, sigmoid routing with a correction bias and a routed scale,
the experts held here) by the ``linear_mla`` configs alone; at their
defaults every other family computes what it computed without them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | vlm | audio | moe | ssm | hybrid | hybrid_moe | mla
    #              | linear_mla
    n_layers: int
    d_model: int
    vocab: int
    # -- attention (ignored for family="ssm") --
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 -> full causal attention
    # -- mlp --
    d_ff: int = 0
    mlp: str = "gated_silu"  # gated_silu | gelu
    norm: str = "rms"  # rms | ln
    tie_embeddings: bool = False
    # -- moe --
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0  # per-expert FFN width (fine-grained MoE)
    capacity_factor: float = 1.25
    # §Perf B4: explicit expert-parallel with_sharding_constraints measured
    # NEUTRAL for inference (GSPMD already picks the EP layout once the
    # per-k dispatch of B3 is in place) and HARMFUL for training (the bwd
    # of the constrained einsums partially replicates: +213%% FLOPs,
    # +78%% collective). Default off; knob kept for future meshes.
    moe_ep_sharding: bool = False
    router_aux_coef: float = 0.01
    # -- ssm (mamba2 / SSD) --
    ssm_state: int = 0  # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # P
    ssm_chunk: int = 256  # Q, SSD chunk length (the BLOCKS knob for SSM)
    ssm_conv_width: int = 4
    ssm_groups: int = 1  # G (B/C projection groups)
    # -- hybrid (zamba2): shared attention block every k mamba layers --
    hybrid_attn_every: int = 6
    hybrid_lora_rank: int = 128
    # -- hybrid_moe (granite-4.0-h): each layer's mixer, "mamba" or
    # "attention"; the published scalar multipliers and norm eps --
    layer_types: tuple[str, ...] = ()
    embedding_multiplier: float = 1.0  # embeddings times this
    residual_multiplier: float = 1.0  # each mixer's and MoE's output times this
    attention_multiplier: float = 0.0  # scores' scale; 0 -> 1/sqrt(head dim)
    logits_scaling: float = 1.0  # logits divided by this
    norm_eps: float = 1e-6  # the RMS norms' and the gated norm's eps
    # -- mla (DeepSeek-V2): the latent c and the shared roped key, the
    # per-head no-rope query/key and value widths --
    kv_lora_rank: int = 0  # c's width
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # YaRN on the rope columns (DeepSeek-V2's yarn_* functions); factor 0:
    # plain RoPE
    yarn_factor: float = 0.0
    yarn_original_max_pos: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0  # mscale = mscale_all_dim: the scores' term
    first_k_dense: int = 0  # leading layers whose FFN is a dense MLP of d_ff
    moe_renormalize: bool = True  # top-k gate weights renormalised over k
    # a prefill of at least this many tokens whose MoE capacity seats
    # every token runs each expert over its own seats, not the padded
    # buffer (1: every such prefill; 0: never)
    moe_ragged_tokens: int = 1
    # -- linear_mla (Kimi-Linear): KDA's heads, head width (keys and values
    # alike), short-conv width and the low rank of its decay and output
    # gates; latent attention without RoPE --
    kda_heads: int = 0
    kda_head_dim: int = 128
    kda_conv_width: int = 4
    kda_gate_rank: int = 128
    mla_nope: bool = False  # the latent layers rotate nothing
    # routing: "softmax" scores, or "sigmoid" scores chosen on score + a
    # per-expert correction bias (the router's ``router_bias``) and weighted
    # by the scores alone; the weights times ``moe_routed_scale``
    moe_score: str = "softmax"
    moe_routed_scale: float = 1.0
    # the experts this card holds of the ``n_experts`` the router scores:
    # ``experts_held`` of them (0: all) from ``expert_offset`` on
    experts_held: int = 0
    expert_offset: int = 0
    # -- enc-dec (seamless) --
    n_enc_layers: int = 0
    # -- modality frontend stubs --
    n_prefix_tokens: int = 0  # vlm: image patches per sample (stub embeddings)
    # -- numerics / compile knobs --
    dtype: str = "bfloat16"
    vocab_round: int = 256  # pad vocab so TP shards evenly
    attn_kv_chunk: int = 1024  # blocks-mode KV chunk size for long seqs
    # §Perf iteration A2: below this KV length, Unique-mode attention beats
    # Blocks (the paper's 'partitioning only pays for longer enough packets'):
    # the chunk scan's hoisted masks + f32 carries cost more HBM traffic than
    # the single materialised score block.
    attn_blocks_threshold: int = 4096
    use_scan: bool = True
    remat: bool = True
    # Dispatch self-attention to the flash kernel
    # (repro_torch.kernels.flash_attention: CUDA on the card, its plain
    # version on CPU tensors). Off by default, as in the reference.
    use_pallas_attention: bool = False
    pallas_interpret: bool = False  # no meaning in the port (field parity)
    # §Perf iteration A3: remat policy. "full" recomputes the whole block in
    # bwd (min memory); "dots_nb" saves weight-matmul outputs (no-batch-dim
    # dots) so projections aren't recomputed — trades a little HBM footprint
    # for less recompute traffic/FLOPs.
    remat_policy: str = "full"  # full | dots_nb
    # §Perf: preferred microbatch count for train cells (0 = auto, prefer 8).
    # zamba2 pins 16: at per-device micro-batch 2 GSPMD partially replicates
    # the wide (2*d_model) shared-attention einsums (+6x FLOPs).
    micro_override: int = 0
    # §Perf B5: chunked prefill (Blocks-mode on the prompt): bound per-token
    # intermediates (MoE dispatch, scores) to O(B*chunk). 0 = single-shot.
    prefill_chunk: int = 0

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab, self.vocab_round)

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def attn_layers(self) -> tuple[int, ...]:
        """``hybrid_moe``: the layers whose mixer is attention."""
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t == "attention")

    @property
    def mamba_layers(self) -> tuple[int, ...]:
        """``hybrid_moe``: the layers whose mixer is Mamba2."""
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t == "mamba")

    @property
    def kda_layers(self) -> tuple[int, ...]:
        """``linear_mla``: the layers whose mixer is KDA."""
        return tuple(i for i, t in enumerate(self.layer_types) if t == "kda")

    @property
    def latent_layers(self) -> tuple[int, ...]:
        """``linear_mla``: the layers whose mixer is latent attention."""
        return tuple(i for i, t in enumerate(self.layer_types) if t == "mla")

    @property
    def n_experts_held(self) -> int:
        """The routed experts whose weights this card holds."""
        return self.experts_held or self.n_experts

    @property
    def mla_rows(self) -> int:
        """``mla``: a latent cache row, c then the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the arch is sub-quadratic: SSM, hybrid, or sliding-window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter count (for 6ND roofline math) ----
    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab_padded, self.n_layers
        Dh, H, Hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            per = self._ssm_params() + 2 * D  # norms
            return emb + L * per + D
        attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
        if self.family == "mla":
            r, dn, dr, dv = (self.kv_lora_rank, self.qk_nope_head_dim,
                             self.qk_rope_head_dim, self.v_head_dim)
            attn = (D * H * (dn + dr) + D * (r + dr) + r
                    + r * H * (dn + dv) + H * dv * D)
        if self.qkv_bias:
            attn += (H + 2 * Hkv) * Dh
        if self.family in ("moe", "hybrid_moe", "mla"):
            E, Fe, S = self.n_experts, self.d_expert or F, self.n_shared_experts
            ff = E * (3 * D * Fe) + S * (3 * D * Fe) + D * E
        elif self.mlp == "gated_silu":
            ff = 3 * D * F
        else:
            ff = 2 * D * F
        if self.family == "hybrid_moe":
            n_attn = len(self.attn_layers)
            return (emb + L * (ff + 2 * D) + n_attn * attn
                    + (L - n_attn) * self._ssm_params() + D)
        per = attn + ff + 2 * D
        total = emb + L * per + D
        if self.family == "mla":  # the leading layers' dense MLPs
            total += self.first_k_dense * (3 * D * F - ff)
        if self.family == "audio":
            # encoder stack (self-attn + mlp) + decoder cross-attn additions
            enc_per = attn + (3 * D * F if self.mlp == "gated_silu" else 2 * D * F) + 2 * D
            total += self.n_enc_layers * enc_per + L * (attn + D)  # cross attn
        if self.family == "hybrid":
            ssm_per = self._ssm_params() + 2 * D
            shared = attn + 3 * D * F + 2 * D
            n_app = math.ceil(L / self.hybrid_attn_every)
            lora = n_app * 2 * (2 * D * self.hybrid_lora_rank)
            return emb + L * ssm_per + shared + lora + D
        return total

    def _ssm_params(self) -> int:
        D, Din, N, G, H = (self.d_model, self.d_inner, self.ssm_state,
                           self.ssm_groups, self.n_ssm_heads)
        in_proj = D * (2 * Din + 2 * G * N + H)
        conv = self.conv_dim * self.ssm_conv_width + self.conv_dim
        out = Din * D
        return in_proj + conv + out + 3 * H + Din  # A_log, D, dt_bias, gate norm

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.family not in ("moe", "hybrid_moe", "mla"):
            return self.param_count()
        D, L = self.d_model, self.n_layers
        E, Fe, S, K = (self.n_experts, self.d_expert or self.d_ff,
                       self.n_shared_experts, self.top_k)
        dense_total = self.param_count()
        inactive = (L - self.first_k_dense) * (E - K) * (3 * D * Fe)
        return dense_total - inactive


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (shape) cell: what gets lowered in the dry-run."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Whether a shape cell runs for this arch (per assignment rules)."""
    if cell.name == "long_500k" and not cfg.supports_long_context:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
