"""Architecture registry: --arch <id> → ModelConfig (full + smoke)."""

from __future__ import annotations

from . import (
    falcon_mamba_7b, granite_moe_1b, hymba_1_5b, internlm2_20b,
    llama_3_2_vision_90b, minitron_4b, mixtral_8x7b, phi3_mini_3_8b,
    qwen2_5_32b, whisper_medium,
)
from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_MODULES = {
    "whisper-medium": whisper_medium,
    "falcon-mamba-7b": falcon_mamba_7b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "mixtral-8x7b": mixtral_8x7b,
    "hymba-1.5b": hymba_1_5b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "internlm2-20b": internlm2_20b,
    "qwen2.5-32b": qwen2_5_32b,
    "minitron-4b": minitron_4b,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.SMOKE if smoke else mod.CONFIG


def all_cells():
    """Every (arch × shape) cell with applicability flags — 40 total."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = shape_applicable(cfg, shape)
            out.append(dict(arch=arch, shape=sname, applicable=ok,
                            reason=reason))
    return out
