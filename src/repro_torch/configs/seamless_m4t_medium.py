"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  [arXiv:2308.11596; hf]

The audio frontend is a STUB per the brief: input_specs() provides
precomputed frame embeddings (B, S_enc, 1024) consumed by the encoder's
input projection.  Vocab 256206 is padded to 256208 for even 16-way TP
sharding (padded logits masked to -inf; excluded from MODEL_FLOPS).
Decode shapes run the decoder with a cross-attention cache over the encoder
states; `long_500k` is skipped (pure full attention).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    padded_vocab=256208,
    pattern=(("attn", "mlp"),),
    n_periods=12,
    n_encoder_layers=12,
    frontend="audio",
    frontend_dim=1024,
    rope_theta=1e4,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=250,
    padded_vocab=256,
    pattern=(("attn", "mlp"),),
    n_periods=2,
    n_encoder_layers=2,
    frontend="audio",
    frontend_dim=32,
    loss_chunk=16,
    attn_chunk=16,
)
