"""stablelm-1.6b [dense]: 24L d_model=2048 32H (MHA, kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    pattern=(("attn", "mlp"),),
    n_periods=24,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="stablelm-1.6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    pattern=(("attn", "mlp"),),
    n_periods=2,
    loss_chunk=16,
    attn_chunk=16,
)
