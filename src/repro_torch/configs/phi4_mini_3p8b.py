"""The port's own copy of ``repro.configs.phi4_mini_3p8b``.

Phi-4-mini 3.8B — RoPE (partial), SwiGLU, GQA kv=8 [arXiv:2412.08905]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attn_kind="gqa",
    pos_kind="rope",
    rope_fraction=0.75,     # phi-4-mini partial rotary factor
    tie_embeddings=True,
)
