"""The port's own copy of ``repro.configs.olmoe_1b_7b``.

OLMoE-1B-7B — 64 experts top-8, qk-norm (Lagom Table 2 workload)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060 (Lagom Table 2)",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    attn_kind="gqa",
    pos_kind="rope",
    qk_norm=True,
    num_experts=64,
    num_shared_experts=0,
    top_k=8,
    moe_d_ff=1024,
)
