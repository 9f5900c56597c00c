"""The port's own copy of ``repro.configs.qwen2_moe_a2p7b``.

Qwen1.5/2-MoE-A2.7B — 4 shared + 60 routed experts top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,              # (dense fallback; all layers are MoE)
    vocab_size=151936,
    attn_kind="gqa",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    attn_bias=True,
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    shared_expert_gate=True,
)
