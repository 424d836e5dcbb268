"""Optimizer base utilities on flat DBuffer shards (port of
``repro/optim/common.py``).

Optimizers run on the rank-local slice of each group buffer, so every
update is one group-fused elementwise pass.  Per-tensor behaviour (weight
decay only on matrices) is recovered from the static plan as a position
mask; the mask never changes, so it is built once per group and rank on
the host from the plan's placements and kept on the device.
"""
from __future__ import annotations

import numpy as np
import torch


def matrix_mask_local(layout, rank: int) -> np.ndarray:
    """(S,) fp32 0/1 mask of rank ``rank``'s shard of ``layout``'s group:
    1 where the flat position belongs to a >=2-D tensor (weight-decay
    eligible).  Host int64 arithmetic, so multi-billion-element groups need
    no blocked coordinates.  PARITY: BITWISE vs the reference's traced
    ``matrix_mask_local``."""
    S = layout.plan.shard_size
    lo, hi = rank * S, (rank + 1) * S
    mask = np.zeros(S, np.float32)
    for pl in layout.plan.placements:
        if len(pl.spec.shape) >= 2:
            a, b = max(pl.offset, lo), min(pl.end, hi)
            if a < b:
                mask[a - lo:b - lo] = 1.0
    return mask


class OptimizerBase:
    def __init__(self, cfg):
        self.cfg = cfg
        self.lr = cfg.learning_rate

    def schedule(self, step: int) -> np.float32:
        """Linear warmup over 100 steps, in float32 on the host from the
        Python step counter (the reference's ``schedule`` on a traced
        int32 step)."""
        warmup = np.float32(100.0)
        return np.float32(self.lr) * np.minimum(
            (np.float32(step) + np.float32(1.0)) / warmup, np.float32(1.0))

    def host_scalars(self, step: int):
        """(lr, c1, c2) in float32 for 0-based ``step`` of an Adam-family
        optimizer (``b1``, ``b2``): the warmup rate and the bias
        corrections ``1 - b**(step + 1)``."""
        lr = self.schedule(step)
        t = np.float32(step) + np.float32(1.0)
        c1 = np.float32(1.0) - np.float32(self.b1) ** t
        c2 = np.float32(1.0) - np.float32(self.b2) ** t
        return lr, c1, c2

    def state_leaves(self) -> dict[str, tuple[torch.dtype, int]]:
        """The state's leaves, ``{key: (dtype, div)}``: per group a tensor
        of the group's shape with the last axis divided by ``div`` (one
        entry per quant block of ``div`` elements)."""
        raise NotImplementedError

    def state_shapes(self, runtime, global_shape: bool = False
                     ) -> dict[str, dict[str, tuple]]:
        """``{key: {group: (dtype, shape)}}`` of the state at the
        rank-local shapes (or, ``global_shape=True``, the global ones)."""
        out = {}
        for k, (dtype, div) in self.state_leaves().items():
            out[k] = {}
            for name, lo in runtime.layouts.items():
                shape = lo.global_shape() if global_shape \
                    else lo.local_shape()
                out[k][name] = (dtype, shape[:-1] + (shape[-1] // div,))
        return out

    def zero_state(self, runtime) -> dict[str, dict[str, torch.Tensor]]:
        """Every leaf of the state, zero, on the runtime's device."""
        return {k: {name: torch.zeros(shape, dtype=dtype,
                                      device=runtime.device)
                    for name, (dtype, shape) in groups.items()}
                for k, groups in self.state_shapes(runtime).items()}

    def init(self, runtime):
        raise NotImplementedError
