"""The port's own copy of ``repro.configs.yi_34b``.

Yi-34B — llama-architecture GQA dense [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    source="arXiv:2403.04652",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attn_kind="gqa",
    pos_kind="rope",
    rope_theta=5_000_000.0,
)
