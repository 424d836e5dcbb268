"""Distributed Buffer (DBuffer): flat group buffers backing RaggedShard
tensors (port of ``repro/core/dbuffer.py``).

  * ``pack`` / ``unpack_np`` -- host-side numpy packing of full tensors
    into the ``(total,)`` global buffer and back.  PARITY: BITWISE.
  * ``unpack`` -- the tensors of a gathered flat torch buffer.  The
    contiguous layouts (ragged, megatron, naive) give zero-copy views
    (``narrow`` + ``view``): every tensor aliases the gathered buffer's
    storage, as the reference's static slices lower to views.  The fsdp2
    layout interleaves each tensor rank-major (chunk k of it sits in rank
    k's shard), so its unpack is a strided Copy-Out -- the overhead the
    paper measures for FSDP2.
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
from .ragged import GroupPlan, Placement


@dataclasses.dataclass(frozen=True)
class DBuffer:
    """Static descriptor binding a GroupPlan to buffer packing/unpacking."""

    plan: GroupPlan

    @property
    def interleaved(self) -> bool:
        return self.plan.mode == "fsdp2"

    def _chunk_col(self, p: Placement) -> tuple[int, int]:
        """fsdp2 layout: (chunk, col) -- the tensor's m even chunks, chunk
        k at ``[k*S + col, k*S + col + chunk)``."""
        return -(-p.spec.size // self.plan.num_shards), \
            p.offset // self.plan.num_shards

    def pack(self, arrays: Mapping[str, np.ndarray]) -> np.ndarray:
        """Dense pack of full tensors into the (total,) fp32 global buffer
        (padding stays zero)."""
        out = np.zeros(self.plan.total, dtype=np.float32)
        m, S = self.plan.num_shards, self.plan.shard_size
        for p in self.plan.placements:
            a = np.asarray(arrays[p.spec.name], dtype=np.float32).reshape(-1)
            if a.size != p.spec.size:
                raise ValueError(f"{p.spec.name}: size mismatch")
            if self.interleaved:
                chunk, col = self._chunk_col(p)
                padded = np.zeros(chunk * m, dtype=np.float32)
                padded[:a.size] = a
                out.reshape(m, S)[:, col:col + chunk] = \
                    padded.reshape(m, chunk)
            else:
                out[p.offset:p.offset + a.size] = a
        return out

    def unpack_np(self, flat: np.ndarray) -> dict[str, np.ndarray]:
        """Host-side inverse of pack (checkpoint restore, tests)."""
        out = {}
        m, S = self.plan.num_shards, self.plan.shard_size
        for p in self.plan.placements:
            if self.interleaved:
                chunk, col = self._chunk_col(p)
                a = flat.reshape(m, S)[:, col:col + chunk].reshape(-1)
                a = a[:p.spec.size]
            else:
                a = flat[p.offset:p.offset + p.spec.size]
            out[p.spec.name] = a.reshape(p.spec.shape)
        return out

    def unpack(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Every tensor of a gathered ``(total,)`` buffer.  Contiguous
        layouts: views of it (no copy; autograd flows through the views
        into ``flat``).  fsdp2: ``flat.reshape(m, S)[:, col:col+chunk]``
        made contiguous -- a strided copy for m > 1 (the Copy-Out); at
        m = 1 the slice is already contiguous, so the tensor is a view."""
        if flat.dim() != 1 or flat.numel() != self.plan.total:
            raise ValueError(
                f"unpack expects a flat ({self.plan.total},) buffer, got "
                f"{tuple(flat.shape)}")
        if not self.interleaved:
            return {p.spec.name: flat.narrow(0, p.offset, p.spec.size)
                    .view(p.spec.shape) for p in self.plan.placements}
        m, S = self.plan.num_shards, self.plan.shard_size
        out = {}
        for p in self.plan.placements:
            chunk, col = self._chunk_col(p)
            t = flat.view(m, S)[:, col:col + chunk].contiguous()
            out[p.spec.name] = t.view(-1)[:p.spec.size].view(p.spec.shape)
        return out

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
        tensor start that is not a quant-block multiple raises.  The fsdp2
        layout has no contiguous per-tensor payload: it decodes the whole
        buffer and unpacks it densely, as the reference does."""
        codes, scales = payload["codes"], payload["scales"]
        if self.interleaved:
            return self.unpack(ops.dequantize_into(
                codes, scales, block, out_dtype=compute_dtype))
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
