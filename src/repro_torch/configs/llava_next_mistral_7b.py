"""llava-next-mistral-7b [vlm]: Mistral-7B backbone + anyres vision stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The anyres vision tower is a STUB per the brief: input_specs() provides 576
precomputed patch embeddings (B, 576, 4096) which the backbone projects and
prepends to the text tokens.  KV heads (8) don't divide the 16-way model axis
and are replicated (q heads shard 32/16=2) — see DESIGN.md §6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    pattern=(("attn", "mlp"),),
    n_periods=32,
    rope_theta=1e6,
    frontend="vision",
    n_frontend_tokens=576,
    frontend_dim=4096,
)

SMOKE_CONFIG = ModelConfig(
    name="llava-next-mistral-7b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pattern=(("attn", "mlp"),),
    n_periods=2,
    frontend="vision",
    n_frontend_tokens=8,
    frontend_dim=32,
    loss_chunk=16,
    attn_chunk=16,
)
