"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, Mamba:attention 7:1 interleave, MoE (16 experts top-2) on every
other layer.  [arXiv:2403.19887; hf]

Period of 8 = [attn+MoE, (mamba+MLP, mamba+MoE) * 3, mamba+MLP], scanned 9x.
The 398B scale is the FSDP/ZeRO stress test: bf16 params alone are 796 GB,
so every parameter's embed dim shards over ('pod','data') in addition to TP
over 'model' (see parallel/sharding.py).
"""
from repro_torch.models.config import ModelConfig

_PERIOD = (
    ("attn", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
    ("mamba", "moe"),
    ("mamba", "mlp"),
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PERIOD,
    n_periods=9,
    n_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    ssm_state=16,
    ssm_expand=2,
    ssm_dt_rank=256,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="jamba-1.5-large-398b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    pattern=(("attn", "moe"), ("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp")),
    n_periods=1,
    n_experts=4,
    experts_per_token=2,
    moe_d_ff=128,
    ssm_state=4,
    ssm_dt_rank=8,
    loss_chunk=16,
    attn_chunk=16,
)
