"""xlstm-350m [ssm]: 24L d_model=1024 4H vocab=50304, alternating sLSTM +
mLSTM blocks with post-up-projection (d_ff=0: blocks carry their own
projections).  [arXiv:2405.04517; unverified]

Pure recurrent state => `long_500k` decode is O(1) per token; the parallel
(quadratic, gated-attention-like) mLSTM form is used for training/prefill.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=(("mlstm", "none"), ("slstm", "none")),
    n_periods=12,
    xlstm_proj_factor=2.0,
)

SMOKE_CONFIG = ModelConfig(
    name="xlstm-350m-smoke",
    family="ssm",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    pattern=(("mlstm", "none"), ("slstm", "none")),
    n_periods=2,
    xlstm_proj_factor=2.0,
    loss_chunk=16,
    attn_chunk=16,
)
