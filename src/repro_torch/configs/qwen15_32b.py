"""qwen1.5-32b [dense]: 64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

40 heads don't divide the 16-way model axis: heads are padded to 48 (3 per
device).  Padding heads are regular parameters (extra capacity when training
from scratch) but are excluded from MODEL_FLOPS, so the §Roofline
useful-compute ratio stays honest.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    pattern=(("attn", "mlp"),),
    n_periods=64,
    qkv_bias=True,
    padded_heads=48,
    padded_kv_heads=48,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    n_layers=2,
    d_model=60,
    n_heads=5,
    n_kv_heads=5,
    d_ff=128,
    vocab_size=256,
    head_dim=12,
    pattern=(("attn", "mlp"),),
    n_periods=2,
    qkv_bias=True,
    padded_heads=6,
    padded_kv_heads=6,
    loss_chunk=16,
    attn_chunk=16,
)
