"""The port's own copy of ``repro.configs.zamba2_7b``.

Zamba2-7B — Mamba2 trunk + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,          # mamba2 layers
    d_model=3584,
    num_heads=32,           # shared attention block heads
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,             # shared block MLP
    vocab_size=32000,
    attn_kind="gqa",
    pos_kind="rope",
    ssm_state=64,           # mamba2 N (state per head)
    ssm_heads=112,          # d_inner=7168, P=64
    ssm_expand=2,
    ssm_groups=1,
    shared_attn_every=6,    # shared transformer block applied every 6 layers
)
