"""Distributed Buffer (DBuffer): flat group buffers backing RaggedShard
tensors (port of ``repro/core/dbuffer.py``).

  * ``pack`` / ``unpack_np`` -- host-side numpy packing of full tensors
    into the ``(total,)`` global buffer and back.  PARITY: BITWISE.
  * ``unpack`` -- the tensors of a gathered flat torch buffer as zero-copy
    views (``narrow`` + ``view``): every tensor aliases the gathered
    buffer's storage, as the reference's static slices lower to views.
    The planner keeps each tensor contiguous, so no copy is ever needed.
  * ``unpack_quant`` -- the serve path's unpack of a gathered q8_block
    payload: eligible 2-D weights stay int8 (``QuantTensor`` views of the
    codes and scales), the rest take one ``dequantize_into`` each.
    PARITY: BITWISE.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from ..kernels import ops
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

    def unpack_quant(self, payload: Mapping[str, torch.Tensor], block: int,
                     compute_dtype: torch.dtype) -> dict:
        """Unpack a gathered q8_block payload (``{"codes", "scales"}`` of
        the full flat buffer) per tensor, without a whole-buffer
        dequantize (the reference's ``unpack_quant``).

        Eligible 2-D tensors (``ops.quant_eligible``) come out as
        ``ops.QuantTensor`` views of their codes and scales slices (no
        copy; in the overhang case of a trailing partial block, the
        ceil-count scales), which ``layers.dense`` multiplies through
        ``ops.q8_matmul``.  Every other tensor takes one
        ``ops.dequantize_into`` of its blocks into ``compute_dtype``.  The
        per-tensor slicing relies on the planner's align guarantee: a
        tensor start that is not a quant-block multiple raises.  (The fsdp2
        layout's branch comes with it, ROADMAP Queue 1 item 10; its
        ``__post_init__`` already refuses that layout.)"""
        codes, scales = payload["codes"], payload["scales"]
        if codes.dim() != 1 or codes.numel() != self.plan.total:
            raise ValueError(
                f"unpack_quant expects flat ({self.plan.total},) codes, got "
                f"{tuple(codes.shape)}")
        out = {}
        for p in self.plan.placements:
            off, size = p.offset, p.spec.size
            if off % block:
                raise ValueError(
                    f"{p.spec.name}: payload offset {off} not a multiple "
                    f"of quant block {block} -- planner align missing?")
            nb = -(-size // block)  # blocks covering the tensor (+ padding)
            s = scales.narrow(0, off // block, nb)
            if ops.quant_eligible(p.spec.shape, block):
                out[p.spec.name] = ops.QuantTensor(
                    codes.narrow(0, off, size).view(p.spec.shape), s, block)
            else:
                t = ops.dequantize_into(codes.narrow(0, off, nb * block), s,
                                        block, out_dtype=compute_dtype)
                out[p.spec.name] = t.narrow(0, 0, size).view(p.spec.shape)
        return out
