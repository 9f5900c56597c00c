"""The port's own copy of ``repro.configs.rwkv6_1p6b``.

RWKV6 "Finch" 1.6B — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # WKV heads (head size 64)
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,             # channel-mix hidden
    vocab_size=65536,
    attn_kind="none",
    pos_kind="none",
    norm_kind="layernorm",
    ssm_state=64,          # per-head state width == head size
    ssm_heads=32,
)
