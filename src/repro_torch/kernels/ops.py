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
from .ref import (adam8bit_store_update_ref, adam8bit_update_ref,
                  adamw_store_update_ref, adamw_update_ref,
                  dequantize_into_ref, encode_ef_ref, q8_matmul_ref,
                  quantize_ref, scalar_stack)

__all__ = [
    "quantize", "dequantize", "dequantize_into", "encode_ef", "q8_matmul",
    "adamw_update", "adam8bit_update", "adamw_store_update",
    "adam8bit_store_update", "quantize_log", "dequantize_log",
    "q8_slice_cols", "QuantTensor", "quant_eligible", "fold_scales",
]
# the leaves of a coded store's core, in ``out`` order
_CORE_KEYS = ("codes", "master", "scales")


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


def _store_out(out, core, *rest):
    """A plain store update's result ``(core, *rest)``, copied into
    ``out`` (the core's leaves first, in ``_CORE_KEYS`` order) when
    given."""
    if out is None:
        return (core, *rest)
    if not isinstance(core, dict):
        return tuple(_copy_out(out, (core, *rest)))
    keys = [k for k in _CORE_KEYS if k in core]
    done = _copy_out(out, tuple(core[k] for k in keys) + rest)
    return (dict(zip(keys, done)), *done[len(keys):])


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
    with fp32 output, its launches counted apart.  PARITY: BITWISE."""
    if _device_kind(codes, scales) == "cuda":
        return blockwise_quant.dequantize(codes, scales, block)
    return dequantize_into_ref(codes, scales, block, torch.float32)


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


def adamw_update(w, g, m, v, mask, *, lr, b1, b2, eps, wd, c1, c2,
                 out=None):
    """The standalone fused AdamW update (the reference's ``adamw_update``):
    flat buffers of n % 128 == 0 elements, a full-size decay mask; returns
    fp32 ``(w', m', v')`` (``out=(w, m, v)`` updates in place).

    PARITY: the CUDA kernel is BITWISE against the plain version on the
    card; the plain version holds ``adamw_store_update``'s fp32 class
    against the reference's interpreted ``_adamw_kernel``."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m, v, mask) == "cuda":
        return fused_update.adamw_update(w, g, m, v, mask, scalars, out=out)
    return tuple(_copy_out(out, adamw_update_ref(w, g, m, v, mask,
                                                 scalars)))


def adam8bit_update(w, g, m8, v8, ms, vs, mask, *, lr, b1, b2, eps, wd, c1,
                    c2, block: int = 1024, out=None):
    """The standalone fused 8-bit Adam update (the reference's
    ``adam8bit_update``): fp32 ``w``, ``g`` and full-size ``mask`` of n
    elements, n % block == 0; int8 moments of w's shape and their fp32
    scales (n / block); returns fp32 ``(w', m8', v8', ms', vs')``.

    PARITY: the CUDA kernel is BITWISE against the plain version on the
    card; the plain version holds ``adam8bit_store_update``'s class against
    the reference's interpreted ``_adam8_kernel``."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m8, v8, ms, vs, mask) == "cuda":
        return fused_update.adam8bit_update(w, g, m8, v8, ms, vs, mask,
                                            scalars, block=block, out=out)
    n = w.numel()
    if block < 1 or n % block:
        raise ValueError(f"adam8bit_update needs n % block == 0, got {n} % "
                         f"{block}")
    shape = (n // block, block)
    res = adam8bit_update_ref(
        w.float().reshape(shape), g.float().reshape(shape),
        m8.reshape(shape), v8.reshape(shape), ms.reshape(-1, 1),
        vs.reshape(-1, 1), mask.float().reshape(shape), scalars, block)
    res = tuple(r.reshape(t.shape) for r, t in
                zip(res, (w, m8, v8, ms, vs)))
    return tuple(_copy_out(out, res))


def adamw_store_update(w, g, m, v, mask, *, lr, b1, b2, eps, wd, c1, c2,
                       fmt: str = "fp32", block: int = 1024, out=None,
                       g_scale=None):
    """Fused AdamW step + store epilogue.  ``w`` and ``g`` fp32 or bf16 (a
    bf16 store passes both in bf16), ``g_scale`` None or a 0-d fp32 tensor
    the gradient is multiplied by in fp32 first.  Flat formats (fp32, bf16)
    return ``(w', m', v')``, ``out=(w, m, v)`` updating in place (the
    optimizer's main path, which saves three transient copies of the
    state).  ``fmt="fp8_e4m3"``/``"fp8_e5m2"`` return ``({"codes",
    "master"}, m', v')``, ``out=(codes, master, m, v)``; ``fmt="q8_block"``
    ``({"codes", "master", "scales"}, m', v')``, ``out=(codes, master,
    scales, m, v)``.

    PARITY: the CUDA kernels are BITWISE against the plain version on the
    card; the plain version is within a few ulp of the reference's
    interpreted kernel (see ``kernels.ref``), its fp8 codes bitwise the
    encode of its w'."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m, v, mask) == "cuda":
        return fused_update.adamw_store_update(
            w, g, m, v, mask, scalars, fmt=fmt, block=block, out=out,
            g_scale=g_scale)
    return _store_out(out, *adamw_store_update_ref(
        w, g, m, v, mask, scalars, fmt, block, g_scale))


def adam8bit_store_update(w, g, m8, v8, ms, vs, mask, *, lr, b1, b2, eps, wd,
                          c1, c2, fmt: str = "fp32", block: int = 1024,
                          out=None, g_scale=None):
    """Fused 8-bit Adam step + store epilogue: decode the int8 moments (m
    linear, v log-space), the Adam step, requantize both moments and write
    w' in the store's format.  ``mask`` is the (S,) uint8 weight-decay row
    shared by every row of ``w`` (..., S); ``g`` fp32 or bf16, times
    ``g_scale`` (None or a 0-d fp32 tensor) in fp32.  Flat formats (fp32,
    bf16) return ``(w', m8', v8', ms', vs')``, ``out=(w, m8, v8, ms, vs)``
    updating in place (the optimizer's main path); the fp8 formats return
    ``({"codes", "master"}, m8', v8', ms', vs')``, ``out=(codes, master,
    m8, v8, ms, vs)``; ``fmt="q8_block"`` ``({"codes", "master",
    "scales"}, m8', v8', ms', vs')``, ``out=(codes, master, scales, m8, v8,
    ms, vs)``.

    PARITY: the CUDA kernel is BITWISE against the plain version on the
    card; the plain version is held to the reference's interpreted kernel
    within the log codec's and the AdamW chain's classes (see
    ``kernels.ref.adam8bit_update_ref``)."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m8, v8, ms, vs, mask) == "cuda":
        return fused_update.adam8bit_store_update(
            w, g, m8, v8, ms, vs, mask, scalars, fmt=fmt, block=block,
            out=out, g_scale=g_scale)
    return _store_out(out, *adam8bit_store_update_ref(
        w, g, m8, v8, ms, vs, mask, scalars, fmt, block, g_scale))


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
