"""The port's own copy of ``repro.configs.h2o_danube_1p8b``.

H2O-Danube 1.8B — llama/mistral mix with sliding-window attention [arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="arXiv:2401.16818",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,         # GQA
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attn_kind="gqa",
    pos_kind="rope",
    sliding_window=4096,    # mistral-style SWA -> long_500k eligible
)
