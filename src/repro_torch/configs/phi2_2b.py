"""The port's own copy of ``repro.configs.phi2_2b``.

Phi-2 2.7B — parallel block, partial rotary, layernorm (Lagom Table 2 workload)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi2-2b",
    family="dense",
    source="microsoft/phi-2 (Lagom Table 2)",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=51200,
    attn_kind="gqa",
    pos_kind="rope",
    rope_fraction=0.4,
    norm_kind="layernorm",
    mlp_kind="gelu",
    parallel_block=True,
    attn_bias=True,
)
