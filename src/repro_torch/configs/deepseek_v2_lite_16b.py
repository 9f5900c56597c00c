"""The port's own copy of ``repro.configs.deepseek_v2_lite_16b``.

DeepSeek-V2-Lite 16B — MLA (kv_lora=512) + MoE [arXiv:2405.04434].

Assignment note: the pool row says both "MoE 64e top-6" and "2 shared+160
routed"; 160 routed belongs to full V2.  V2-Lite's model card is 64 routed
+ 2 shared, top-6 — we follow the card and the "64e top-6" half of the row.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,        # MLA: all heads share the compressed kv latent
    head_dim=128,
    d_ff=10944,             # first dense layer
    vocab_size=102400,
    attn_kind="mla",
    pos_kind="rope",
    kv_lora_rank=512,
    q_lora_rank=0,          # V2-Lite has no q compression
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    shared_d_ff=2816,
    first_dense_layers=1,
)
