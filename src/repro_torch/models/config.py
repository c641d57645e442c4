"""Model + shape configuration for the assigned architecture pool.

A copy of ``repro/models/config.py`` (pure data, no JAX), so the port and
the reference read the same ``ModelConfig``s."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# A block is (mixer, ffn).  Mixers: 'attn' (full), 'swa' (sliding-window),
# 'mamba', 'mlstm', 'slstm'.  FFNs: 'mlp', 'moe', 'none'.
Block = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Block, ...]  # one period of the repeating layer pattern
    n_periods: int
    remainder: Tuple[Block, ...] = ()  # layers after the scanned periods
    head_dim: int = 0  # 0 => d_model // n_heads
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0  # qwen2-moe shared experts (always-on)
    capacity_factor: float = 1.25
    # attention details
    sliding_window: int = 0
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # SSM (mamba)
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 256
    # xLSTM
    xlstm_proj_factor: float = 2.0
    # encoder-decoder
    n_encoder_layers: int = 0
    # modality frontend stub ('vision' | 'audio' | None): input_specs() feeds
    # precomputed embeddings; the backbone prepends them to token embeddings.
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    frontend_dim: int = 0
    # numerics / fitting knobs (hillclimbable)
    dtype: str = "bfloat16"
    kv_dtype: str = ""  # KV-cache storage dtype ('' => dtype); f8 halves MHA caches
    remat: str = "full"  # 'none' | 'full' | 'dots'
    loss_chunk: int = 512  # sequence chunk for the vocab projection + xent
    attn_chunk: int = 1024  # kv-block size for chunked (flash-in-XLA) attention
    # padded sizes for even TP sharding (see DESIGN.md §6); 0 => no padding
    padded_heads: int = 0
    padded_kv_heads: int = 0
    padded_vocab: int = 0
    padded_experts: int = 0

    # -- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def heads_p(self) -> int:
        return self.padded_heads or self.n_heads

    @property
    def kv_heads_p(self) -> int:
        return self.padded_kv_heads or self.n_kv_heads

    @property
    def vocab_p(self) -> int:
        return self.padded_vocab or self.vocab_size

    @property
    def experts_p(self) -> int:
        return self.padded_experts or self.n_experts

    @property
    def all_blocks(self) -> Tuple[Block, ...]:
        return self.pattern * self.n_periods + self.remainder

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    def supports_long_context(self) -> bool:
        """Sub-quadratic state growth: SSM / hybrid / mostly-local attention."""
        kinds = [m for m, _ in self.all_blocks]
        n_full = sum(1 for k in kinds if k == "attn")
        return n_full == 0 or (n_full / len(kinds)) <= 0.25

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (unpadded, for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.hd
        n = 2 * self.vocab_size * d  # embedding + untied lm head
        for mixer, ffn in self.all_blocks:
            if mixer in ("attn", "swa"):
                n += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                n += (self.n_heads * hd) * d + d  # wo + ln
            elif mixer == "mamba":
                di = self.ssm_expand * d
                n += d * 2 * di + self.ssm_conv * di + 3 * di * self.ssm_state
                n += di * self.ssm_dt_rank * 2 + 2 * di + di * d + d
            elif mixer == "mlstm":
                f = int(self.xlstm_proj_factor * d)
                n += d * 2 * f + 3 * f * f + 3 * f + f * d + d
            elif mixer == "slstm":
                u = d
                n += d * 4 * u + 4 * u * (u // max(self.n_heads, 1)) + 4 * u + d
            if ffn == "mlp":
                n += 3 * d * self.d_ff + d
            elif ffn == "moe":
                k = self.experts_per_token if active_only else self.n_experts
                n += k * 3 * d * self.moe_d_ff + d * self.n_experts + d
                if self.shared_d_ff:
                    n += 3 * d * self.shared_d_ff
        if self.is_encdec:
            for _ in range(self.n_encoder_layers):
                n += 4 * d * (self.n_heads * hd) + 3 * d * self.d_ff + 2 * d
            # decoder cross-attention
            n += len(self.all_blocks) * (4 * d * (self.n_heads * hd) + d)
        return n


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def dense(n: int) -> Tuple[Block, ...]:
    return (("attn", "mlp"),) * n
