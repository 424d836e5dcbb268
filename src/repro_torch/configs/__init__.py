"""Architecture registry: the configs whose model the port can build."""
from __future__ import annotations

import importlib

from .base import SHAPES, ModelConfig, ParallelConfig, ShapeConfig, with_tp

# public arch id -> module name (the reference's twelve)
_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen1.5-32b": "qwen1_5_32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "gemma2-2b": "gemma2_2b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    # the paper's own evaluation models
    "llama3-70b": "llama3_70b",
    "gpt-oss-120b": "gpt_oss_120b",
    "nemotron-4-340b": "nemotron_4_340b",
    # the recurrent families
    "xlstm-125m": "xlstm_125m",
    "hymba-1.5b": "hymba_1_5b",
    # the cross-attention families
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

ARCH_IDS = list(_MODULES)
# the reference's ten assigned ids, in its order (the dry run's ``--all``)
ASSIGNED_ARCH_IDS = [
    "qwen2.5-14b", "llama-3.2-vision-90b", "qwen1.5-32b", "xlstm-125m",
    "hymba-1.5b", "seamless-m4t-medium", "granite-moe-1b-a400m",
    "gemma2-2b", "qwen3-moe-235b-a22b", "nemotron-4-340b",
]


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def build_model(cfg: ModelConfig):
    from ..models.encdec import EncDecModel
    from ..models.recurrent import HymbaModel, XLSTMModel
    from ..models.transformer import DecoderLM

    if cfg.arch_type in ("dense", "moe", "vlm"):
        return DecoderLM(cfg)
    if cfg.arch_type == "ssm":
        return XLSTMModel(cfg)
    if cfg.arch_type == "hybrid":
        return HymbaModel(cfg)
    if cfg.arch_type == "audio":
        return EncDecModel(cfg)
    raise ValueError(cfg.arch_type)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Which (arch x shape) pairs run: the reference's skips, line for
    line."""
    if shape.name == "long_500k":
        if cfg.arch_type in ("ssm", "hybrid"):
            return True, ""
        if cfg.sliding_window:
            return True, "sliding-window cache variant"
        return False, "pure full-attention arch: 500k dense KV out of scope"
    return True, ""


__all__ = ["ModelConfig", "ParallelConfig", "ShapeConfig", "SHAPES",
           "ARCH_IDS", "ASSIGNED_ARCH_IDS", "get_config", "build_model",
           "supports_shape"]
