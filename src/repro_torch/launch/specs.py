"""Meta-tensor stand-ins for every input of a step (port of
``repro/launch/specs.py``): shapes and dtypes, no values, no device
memory.  This is what the dry run (``launch.dryrun``) runs a step on.

The reference's stand-ins carry the global shape and a sharding; the
port's carry rank 0's local shape: the train batch cut by
``FSDPRuntime.batch_slice``, the serve cache by ``local_cache_shapes``
(rows and, under tp, the KV head slot), parameters and optimizer state at
their shard shapes.  The serve steps take the global token batch and cut
it themselves (``FSDPRuntime._serve_call``), so a prefill or decode batch
is the global one.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.fsdp import local_cache_shapes
from ..models.cache import tree_map


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, runtime):
    """The step's batch for one (arch, shape) pair: int64 tokens (the data
    stream's ``shard`` dtype), a VLM's bf16 ``patches`` (B, n_patches,
    d_model) and an encoder-decoder's bf16 ``frames`` (B, min(n_frames,
    seq_len), d_model), as the reference's; rank 0's rows of a train
    batch, the global rows of a serve batch; one position a row for
    decode."""
    B = shape.global_batch
    T = shape.seq_len if shape.kind != "decode" else 1
    if shape.kind == "train":
        lo, hi = runtime.batch_slice(B)
        B = hi - lo
    batch = {"tokens": _meta((B, T), torch.long)}
    if cfg.arch_type == "vlm":
        batch["patches"] = _meta((B, cfg.n_patches, cfg.d_model),
                                 torch.bfloat16)
    if cfg.arch_type == "audio":
        batch["frames"] = _meta(
            (B, min(cfg.n_frames, shape.seq_len), cfg.d_model),
            torch.bfloat16)
    return batch


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, runtime, model):
    """Rank 0's part of the serve cache of ``shape.global_batch`` rows and
    ``shape.seq_len`` positions (``FSDPRuntime.init_cache``'s shapes; the
    recurrent families' nested caches in their nesting)."""
    lo, hi = runtime.batch_slice(shape.global_batch)
    return tree_map(lambda sd: _meta(*sd), local_cache_shapes(
        model, shape.global_batch, shape.seq_len, hi - lo, runtime.tp))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, runtime, model,
                optimizer=None):
    """All inputs of the step implied by ``shape.kind``, on a runtime on
    the meta device:

    train   -> (params, opt_state, step, batch)
    prefill -> (params, batch, cache)
    decode  -> (params, batch, cache, index)

    ``step`` is the Python int 0 and ``index`` the last position; the
    optimizer's state comes from ``optimizer.init`` (meta zeros of
    ``state_shapes``, and its masks)."""
    params = runtime.param_shapes()
    if shape.kind == "train":
        return (params, optimizer.init(runtime), 0,
                batch_specs(cfg, shape, runtime))
    cache = cache_specs(cfg, shape, runtime, model)
    if shape.kind == "prefill":
        return (params, batch_specs(cfg, shape, runtime), cache)
    return (params, batch_specs(cfg, shape, runtime), cache,
            shape.seq_len - 1)
