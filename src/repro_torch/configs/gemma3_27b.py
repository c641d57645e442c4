"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Pattern period = 5 sliding-window layers (window 1024) + 1 global layer;
62 = 10 periods * 6 + 2 remainder local layers (run unrolled post-scan).
Local layers keep only a 1024-slot ring-buffer KV cache, which is what makes
`long_500k` decode feasible: only ~1/6 of layers hold full-length KV.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    pattern=(("swa", "mlp"),) * 5 + (("attn", "mlp"),),
    n_periods=10,
    remainder=(("swa", "mlp"),) * 2,
    sliding_window=1024,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-27b-smoke",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pattern=(("swa", "mlp"),) * 2 + (("attn", "mlp"),),
    n_periods=1,
    remainder=(("swa", "mlp"),),
    sliding_window=8,
    loss_chunk=16,
    attn_chunk=16,
)
