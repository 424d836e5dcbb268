"""The dispatch layer for the port's kernels (port of
``repro/kernels/ops.py`` for the ops the port runs).

Rule: CUDA tensors launch the hand-written kernel; CPU tensors take the
plain PyTorch version (``kernels.ref``), the CPU tests' path; anything
else -- tensors split across devices, another device type -- raises.
There is no fallback from a failed build or launch to the plain version.
Every hot path of the port (the wire codecs, the store, the optimizer)
goes through these functions.
"""
from __future__ import annotations

import torch

from . import blockwise_quant, encode_ef as _encode_ef, fused_update
from . import q8_matmul as _q8mm
from .q8_matmul import QuantTensor, fold_scales, q8_slice_cols, \
    quant_eligible
from ..quant.blockwise import dequantize_blockwise_log, \
    quantize_blockwise_log
from .ref import (adam8bit_store_update_ref, adamw_store_update_ref,
                  dequantize_into_ref, encode_ef_ref, q8_matmul_ref,
                  quantize_ref, scalar_stack)

__all__ = [
    "quantize", "dequantize", "dequantize_into", "encode_ef", "q8_matmul",
    "adamw_store_update", "adam8bit_store_update", "quantize_log",
    "dequantize_log", "q8_slice_cols", "QuantTensor", "quant_eligible",
    "fold_scales",
]


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    devices = {t.device for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devices) == 1:
        return "cuda"
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA device, "
        f"got {sorted(str(d) for d in devices)}")


def _copy_out(out, results):
    if out is None:
        return results
    for dst, src in zip(out, results):
        dst.copy_(src)
    return out


def quantize(x: torch.Tensor, block: int = 1024):
    """Blockwise absmax INT8 encode: ``(codes int8 like x, scales f32
    (..., n // block))`` (store create, wire encode).

    PARITY: the kernel is BITWISE against the plain version on the card;
    the plain version is bitwise the reference's but for subnormal scales
    (``quant.blockwise``)."""
    if _device_kind(x) == "cuda":
        return blockwise_quant.quantize(x, block)
    return quantize_ref(x, block)


def dequantize_into(codes: torch.Tensor, scales: torch.Tensor,
                    block: int = 1024, *, out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """Gather-path decode: codes + scales -> ``out_dtype`` in one pass, no
    full-size fp32 intermediate.

    PARITY: BITWISE (kernel vs plain version on the card; plain version vs
    the reference)."""
    if _device_kind(codes, scales) == "cuda":
        return blockwise_quant.dequantize_into(codes, scales, block,
                                               out_dtype)
    return dequantize_into_ref(codes, scales, block, out_dtype)


def dequantize(codes: torch.Tensor, scales: torch.Tensor,
               block: int = 1024) -> torch.Tensor:
    """Blockwise decode to fp32 (the q8 reduce route): ``dequantize_into``
    with fp32 output.  PARITY: BITWISE."""
    return dequantize_into(codes, scales, block, out_dtype=torch.float32)


def encode_ef(ct: torch.Tensor, ef: torch.Tensor, block: int = 1024, *,
              out=None):
    """Reduce-path fused encode with error feedback: ``(codes, scales,
    new_ef)`` of ``comp = ct.f32 + ef``; ``out=(codes, scales, ef)``
    updates the residual in place.

    PARITY: the kernel is BITWISE against the plain version on the card;
    the plain version vs the reference: codes and scales bitwise (but for
    subnormal scales), new_ef within XLA's FMA contraction of ``comp -
    codes*scale`` (``kernels.ref.encode_ef_ref``)."""
    if _device_kind(ct, ef) == "cuda":
        return _encode_ef.encode_ef(ct, ef, block, out=out)
    return _copy_out(out, encode_ef_ref(ct, ef, block))


def q8_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              block: int = 1024, *, out_dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """Serve-path int8 x int8 GEMM on gathered codes: ``x`` (..., K) fp32
    or bf16, ``codes`` (K, N) int8, ``scales`` the flat f32 block scales of
    a case A or case B layout (``quant_eligible``); returns (..., N) in
    ``out_dtype`` (default x's dtype) without materializing the dequantized
    weight.  The reference's ``ValueError``s on the layout and the scale
    count come first, on every device.

    PARITY: the kernel is BITWISE against the plain version on the card;
    the plain version is BITWISE against the reference's interpreted
    kernel on the tests' inputs (``kernels.ref.q8_matmul_ref``); both are
    ALLCLOSE to the dense ``x @ dequantize(w)``."""
    k, n = codes.shape
    _q8mm.check_args(k, n, block, scales.numel())
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if _device_kind(x, codes, scales) == "cuda":
        return _q8mm.q8_matmul(x, codes, scales, block, out_dtype)
    return q8_matmul_ref(x, codes, scales, block, out_dtype)


def adamw_store_update(w, g, m, v, mask, *, lr, b1, b2, eps, wd, c1, c2,
                       fmt: str = "fp32", block: int = 1024, out=None):
    """Fused AdamW step + store epilogue.  Flat formats (fp32, bf16)
    return ``(w', m', v')``, ``out=(w, m, v)`` updating in place (the
    optimizer's main path, which saves three transient copies of the
    state).  ``fmt="q8_block"`` returns ``({"codes", "master", "scales"},
    m', v')``; ``out=(codes, master, scales, m, v)``.

    PARITY: the CUDA kernels are BITWISE against the plain version on the
    card; the plain version is within a few ulp of the reference's
    interpreted kernel (see ``kernels.ref``)."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m, v, mask) == "cuda":
        return fused_update.adamw_store_update(w, g, m, v, mask, scalars,
                                               fmt=fmt, block=block, out=out)
    core, m2, v2 = adamw_store_update_ref(w, g, m, v, mask, scalars, fmt,
                                          block)
    if out is None:
        return core, m2, v2
    if fmt == "q8_block":
        codes, master, scales, m_out, v_out = _copy_out(
            out, (core["codes"], core["master"], core["scales"], m2, v2))
        return ({"codes": codes, "master": master, "scales": scales},
                m_out, v_out)
    return tuple(_copy_out(out, (core, m2, v2)))


def adam8bit_store_update(w, g, m8, v8, ms, vs, mask, *, lr, b1, b2, eps, wd,
                          c1, c2, fmt: str = "fp32", block: int = 1024,
                          out=None):
    """Fused 8-bit Adam step + store epilogue: decode the int8 moments (m
    linear, v log-space), the Adam step, requantize both moments and write
    w' in the store's format.  ``mask`` is the (S,) uint8 weight-decay row
    shared by every row of ``w`` (..., S).  Flat formats (fp32, bf16)
    return ``(w', m8', v8', ms', vs')``, ``out=(w, m8, v8, ms, vs)``
    updating in place (the optimizer's main path); ``fmt="q8_block"``
    returns ``({"codes", "master", "scales"}, m8', v8', ms', vs')``,
    ``out=(codes, master, scales, m8, v8, ms, vs)``.

    PARITY: the CUDA kernel is BITWISE against the plain version on the
    card; the plain version is held to the reference's interpreted kernel
    within the log codec's and the AdamW chain's classes (see
    ``kernels.ref.adam8bit_update_ref``)."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m8, v8, ms, vs, mask) == "cuda":
        return fused_update.adam8bit_store_update(
            w, g, m8, v8, ms, vs, mask, scalars, fmt=fmt, block=block,
            out=out)
    core, *moments = adam8bit_store_update_ref(w, g, m8, v8, ms, vs, mask,
                                               scalars, fmt, block)
    if out is None:
        return (core, *moments)
    if fmt == "q8_block":
        done = _copy_out(out, (core["codes"], core["master"], core["scales"],
                               *moments))
        return ({"codes": done[0], "master": done[1], "scales": done[2]},
                *done[3:])
    return tuple(_copy_out(out, (core, *moments)))


def quantize_log(x: torch.Tensor, block: int = 1024):
    """Log-space blockwise quantize (8-bit Adam's v): the plain version on
    every device -- no standalone kernel, ``adam8bit_store_update`` fuses
    it, as in the reference.  PARITY: see ``quant.blockwise``."""
    return quantize_blockwise_log(x, block)


def dequantize_log(codes: torch.Tensor, scales: torch.Tensor,
                   block: int = 1024) -> torch.Tensor:
    """Log-space blockwise decode; a plain passthrough like
    ``quantize_log``."""
    return dequantize_blockwise_log(codes, scales, block)
