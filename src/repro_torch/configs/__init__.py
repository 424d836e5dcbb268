"""Architecture registry: the configs whose model the port can build."""
from __future__ import annotations

import importlib

from .base import ModelConfig, ParallelConfig

# public arch id -> module name (the reference registers twelve; the port
# adds an id once it runs that family -- ROADMAP Queue 1 item 14b)
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
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ported: {ARCH_IDS}); other "
            f"families come with ROADMAP Queue 1 item 14b")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


def build_model(cfg: ModelConfig):
    from ..models.transformer import DecoderLM

    if cfg.arch_type in ("dense", "moe"):
        return DecoderLM(cfg)
    raise NotImplementedError(
        f"arch_type {cfg.arch_type!r} is not ported yet (ROADMAP Queue 1 "
        f"item 14b)")


__all__ = ["ModelConfig", "ParallelConfig", "ARCH_IDS", "get_config",
           "build_model"]
