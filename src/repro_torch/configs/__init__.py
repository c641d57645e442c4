"""Architecture registry: ``--arch <id>`` resolves through here."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig

_MODULES: Dict[str, str] = {
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a27b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_16b",
    "qwen1.5-32b": "repro_torch.configs.qwen15_32b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_15_large_398b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cell_is_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live dry-run cell, else the skip reason."""
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if shape == "long_500k" and not cfg.supports_long_context():
        return False, "pure full-attention arch: 500k dense KV unsupported (DESIGN.md §5)"
    return True, ""


def runnable_cells():
    for a in ARCHS:
        for s in SHAPES:
            ok, why = cell_is_runnable(a, s)
            yield a, s, ok, why
