"""Model configuration schema (the port's own copy of ``repro.configs.base``).

One ``ModelConfig`` describes any architecture in the zoo: dense GQA
decoders, sliding-window variants, MoE (shared + routed experts), MLA,
RWKV6 (attention-free), Mamba2/Zamba2 hybrids, Whisper-style
encoder-decoder, and VLM backbones with M-RoPE.  The fields are a
superset; each family reads the subset it needs.  The port keeps its own
copy so that it imports nothing of the JAX package; the tests hold the two
copies equal field for field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ModelConfig:
    # --- identity -------------------------------------------------------
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""            # citation (arXiv id / model card)

    # --- trunk ----------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // num_heads
    d_ff: int = 0               # dense-MLP hidden size
    vocab_size: int = 0
    max_seq_len: int = 1 << 19

    # --- attention ------------------------------------------------------
    attn_kind: str = "gqa"      # gqa | mla | none
    pos_kind: str = "rope"      # rope | mrope | alibi | learned | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # partial rotary (stablelm / phi style)
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE dims per (t, h, w) section
    sliding_window: int = 0     # 0 -> full causal attention
    attn_bias: bool = False
    qk_norm: bool = False

    # --- MLA (deepseek-v2) ------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0        # 0 -> full-rank q projection
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- block / mlp ------------------------------------------------------
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm
    mlp_kind: str = "swiglu"    # swiglu | gelu
    parallel_block: bool = False  # attn and mlp read the same norm (phi-2)
    tie_embeddings: bool = False

    # --- MoE --------------------------------------------------------------
    num_experts: int = 0        # routed experts (0 -> dense MLP)
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-expert ffn hidden
    shared_d_ff: int = 0        # shared-expert ffn hidden (0 -> moe_d_ff * n_shared)
    first_dense_layers: int = 0  # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    shared_expert_gate: bool = False  # qwen2-moe gates its shared expert

    # --- SSM / RWKV ---------------------------------------------------------
    ssm_state: int = 0          # state dim per head (mamba2) / head size (rwkv)
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_groups: int = 1         # B/C groups for mamba2
    conv_kernel: int = 4

    # --- hybrid (zamba2) ----------------------------------------------------
    shared_attn_every: int = 0  # apply the shared attention block every k layers

    # --- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0        # stub frontend output length (audio frames)

    # --- modality stub (audio / vlm) ------------------------------------------
    frontend_stub: bool = False  # inputs are precomputed embeddings

    # --- numerics --------------------------------------------------------------
    dtype: str = "float32"

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_kv_heads == 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.attn_kind == "mla" and self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)

    # --- derived ------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for long_500k decode (sub-quadratic / windowed attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have no decode step; all ours decode."""
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- parameter count (analytic, for roofline MODEL_FLOPS) ----------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count.  ``active_only`` counts MoE experts at
        top_k (+ shared) instead of all routed experts — the 6·N_active·D
        convention for MoE roofline."""
        d = self.d_model
        p = 0
        # embeddings (+ untied head)
        p += self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attn_kind == "mla":
                q_in = self.q_lora_rank or d
                qhd = self.qk_nope_head_dim + self.qk_rope_head_dim
                a = 0
                if self.q_lora_rank:
                    a += d * self.q_lora_rank
                a += q_in * self.num_heads * qhd
                a += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                a += self.kv_lora_rank * self.num_heads * (self.qk_nope_head_dim + self.v_head_dim)
                a += self.num_heads * self.v_head_dim * d
                return a
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d

        def mlp_params(hidden: int) -> int:
            mult = 3 if self.mlp_kind == "swiglu" else 2
            return mult * d * hidden

        if self.family == "ssm":       # rwkv6
            # time-mix: r,k,v,g,o projections + decay loras; channel-mix 2 mats
            p += self.num_layers * (5 * d * d + 2 * d * self.d_ff)
        elif self.family == "hybrid":  # zamba2: mamba2 layers + one shared attn block
            d_in = self.ssm_expand * d
            per_mamba = d * (2 * d_in + 2 * self.ssm_groups * self.ssm_state) + d_in * d
            p += self.num_layers * per_mamba
            p += attn_params() * 2 + mlp_params(self.d_ff)  # shared block (concat input ~2x)
        else:
            layers = self.num_layers + self.encoder_layers
            p += layers * attn_params()
            if self.is_encoder_decoder:
                p += self.num_layers * attn_params()  # cross attention
            moe_layers = max(0, self.num_layers - self.first_dense_layers) if self.is_moe else 0
            dense_layers = layers - moe_layers
            p += dense_layers * mlp_params(self.d_ff)
            if moe_layers:
                n_routed = self.top_k if active_only else self.num_experts
                p += moe_layers * (n_routed * mlp_params(self.moe_d_ff)
                                   + mlp_params(self.shared_d_ff or self.moe_d_ff * self.num_shared_experts)
                                   + d * self.num_experts)
        return p


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: ≤2 layers, d_model ≤ 256, ≤4 experts."""
    heads = min(cfg.num_heads, 4) or 4
    kv = max(1, min(cfg.num_kv_heads, heads))
    if cfg.num_kv_heads < cfg.num_heads:  # preserve GQA grouping
        kv = max(1, heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    d_model = min(256, cfg.d_model)
    head_dim = d_model // heads
    kw = dict(
        num_layers=min(2, cfg.num_layers) or 2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=head_dim,
        d_ff=min(512, cfg.d_ff) if cfg.d_ff else 0,
        vocab_size=min(512, cfg.vocab_size),
        max_seq_len=4096,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.is_moe:
        kw.update(num_experts=min(4, cfg.num_experts),
                  top_k=min(2, cfg.top_k),
                  moe_d_ff=min(128, cfg.moe_d_ff),
                  shared_d_ff=min(128, cfg.shared_d_ff) if cfg.shared_d_ff else 0,
                  first_dense_layers=min(1, cfg.first_dense_layers))
    if cfg.attn_kind == "mla":
        kw.update(kv_lora_rank=64, q_lora_rank=min(cfg.q_lora_rank, 64) if cfg.q_lora_rank else 0,
                  qk_nope_head_dim=head_dim, qk_rope_head_dim=max(8, head_dim // 2),
                  v_head_dim=head_dim)
    if cfg.mrope_sections:
        h = head_dim // 2
        kw.update(mrope_sections=(h - 2 * (h // 3), h // 3, h // 3))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=min(cfg.ssm_state, 16) or 16,
                  ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
                  shared_attn_every=2 if cfg.shared_attn_every else 0)
    if cfg.is_encoder_decoder:
        kw.update(encoder_layers=2, encoder_seq=64)
    return cfg.replace(**kw)
