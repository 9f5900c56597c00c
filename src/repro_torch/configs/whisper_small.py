"""The port's own copy of ``repro.configs.whisper_small``.

Whisper-small — enc-dec; conv/mel frontend is a stub (precomputed frames) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,          # decoder layers
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    attn_kind="gqa",
    pos_kind="learned",
    norm_kind="layernorm",
    mlp_kind="gelu",
    attn_bias=True,
    is_encoder_decoder=True,
    encoder_seq=1500,       # stub frontend: precomputed frame embeddings
    frontend_stub=True,
    tie_embeddings=True,
    max_seq_len=32768,      # decode_32k stress shape bounds the learned-pos table
)
