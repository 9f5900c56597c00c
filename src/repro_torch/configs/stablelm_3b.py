"""The port's own copy of ``repro.configs.stablelm_3b``.

StableLM family config (assigned dims) — partial rotary, layernorm [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    attn_kind="gqa",
    pos_kind="rope",
    rope_fraction=0.25,     # stablelm partial rotary
    norm_kind="layernorm",
)
