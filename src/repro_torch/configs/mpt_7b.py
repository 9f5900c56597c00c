"""The port's own copy of ``repro.configs.mpt_7b``.

MPT-7B — ALiBi positions, layernorm (Lagom Table 2 workload)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mpt-7b",
    family="dense",
    source="mosaicml/mpt-7b (Lagom Table 2)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=16384,
    vocab_size=50432,
    attn_kind="gqa",
    pos_kind="alibi",
    norm_kind="layernorm",
    mlp_kind="gelu",
    tie_embeddings=True,
)
