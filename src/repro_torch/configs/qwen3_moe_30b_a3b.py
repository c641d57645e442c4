"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) expert d_ff=768,
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

Every layer is (attention, MoE); there is no dense FFN.  Experts shard 128/16
= 8 per device over the model axis (EP); kv=4 heads replicate.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    pattern=(("attn", "moe"),),
    n_periods=48,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    pattern=(("attn", "moe"),),
    n_periods=2,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=96,
    loss_chunk=16,
    attn_chunk=16,
)
