"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) expert d_ff=1408,
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

The 4 shared (always-on) experts are modelled as one dense SwiGLU of width
4*1408 = 5632 alongside the routed experts.  60 routed experts don't divide
the 16-way model axis, so the expert dim is padded to 64 (router logits for
padding experts are masked to -inf; they are excluded from MODEL_FLOPS).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    pattern=(("attn", "moe"),),
    n_periods=24,
    n_experts=60,
    experts_per_token=4,
    moe_d_ff=1408,
    shared_d_ff=5632,
    padded_experts=64,
    rope_theta=1e6,
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=256,
    pattern=(("attn", "moe"),),
    n_periods=2,
    n_experts=6,
    experts_per_token=2,
    moe_d_ff=96,
    shared_d_ff=128,
    padded_experts=8,
    qkv_bias=True,
    loss_chunk=16,
    attn_chunk=16,
)
