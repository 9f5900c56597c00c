"""The port's own copy of ``repro.configs.qwen2_vl_72b``.

Qwen2-VL-72B backbone — M-RoPE, dynamic resolution; vision encoder stubbed [arXiv:2409.12191]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    attn_kind="gqa",
    pos_kind="mrope",
    mrope_sections=(16, 24, 24),   # (temporal, height, width) rotary dims
    rope_theta=1_000_000.0,
    attn_bias=True,
    frontend_stub=True,            # ViT + projector stubbed: patch embeddings in
)
