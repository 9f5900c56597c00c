"""The port's own copy of ``repro.configs.llama3_8b``.

Llama-3-8B (Lagom Table 2 workload)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    source="meta-llama/Meta-Llama-3-8B (Lagom Table 2)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    attn_kind="gqa",
    pos_kind="rope",
    rope_theta=500_000.0,
)
