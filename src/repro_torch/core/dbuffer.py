"""Distributed Buffer (DBuffer): flat group buffers backing RaggedShard
tensors (port of ``repro/core/dbuffer.py``).

  * ``pack`` / ``unpack_np`` -- host-side numpy packing of full tensors
    into the ``(total,)`` global buffer and back.  PARITY: BITWISE.
  * ``unpack`` -- the tensors of a gathered flat torch buffer as zero-copy
    views (``narrow`` + ``view``): every tensor aliases the gathered
    buffer's storage, as the reference's static slices lower to views.
    The planner keeps each tensor contiguous, so no copy is ever needed.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .ragged import GroupPlan


@dataclasses.dataclass(frozen=True)
class DBuffer:
    """Static descriptor binding a GroupPlan to buffer packing/unpacking."""

    plan: GroupPlan

    def __post_init__(self):
        if self.plan.mode != "ragged":
            raise NotImplementedError(
                f"DBuffer layout {self.plan.mode!r} is not ported yet "
                f"(ROADMAP Queue 1 item 10)")

    def pack(self, arrays: Mapping[str, np.ndarray]) -> np.ndarray:
        """Dense pack of full tensors into the (total,) fp32 global buffer
        (padding stays zero)."""
        out = np.zeros(self.plan.total, dtype=np.float32)
        for p in self.plan.placements:
            a = np.asarray(arrays[p.spec.name], dtype=np.float32).reshape(-1)
            if a.size != p.spec.size:
                raise ValueError(f"{p.spec.name}: size mismatch")
            out[p.offset:p.offset + a.size] = a
        return out

    def unpack_np(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        """Host-side inverse of pack (checkpoint restore, tests)."""
        return {p.spec.name: flat[p.offset:p.offset + p.spec.size]
                .reshape(p.spec.shape) for p in self.plan.placements}

    def unpack(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every tensor of a gathered ``(total,)`` buffer as a view of it
        (no copy; autograd flows through the views into ``flat``)."""
        if flat.dim() != 1 or flat.numel() != self.plan.total:
            raise ValueError(
                f"unpack expects a flat ({self.plan.total},) buffer, got "
                f"{tuple(flat.shape)}")
        return {p.spec.name: flat.narrow(0, p.offset, p.spec.size)
                .view(p.spec.shape) for p in self.plan.placements}
