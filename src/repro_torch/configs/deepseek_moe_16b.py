"""The port's own copy of ``repro.configs.deepseek_moe_16b``.

DeepSeek-MoE-16B — 64 routed + 2 shared, top-6 (Lagom Table 2 workload)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066 (Lagom Table 2)",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    attn_kind="gqa",
    pos_kind="rope",
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    shared_d_ff=2816,
    first_dense_layers=1,
)
