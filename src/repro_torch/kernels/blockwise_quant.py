"""Block-wise INT8 quantize and dequantize-into on the card.

Replaces ``repro/kernels/blockwise_quant.py``: ``quantize``
(``_quant_kernel``, launched at ``:91``) and ``dequantize_into``
(``_dequant_kernel``, launched at ``:130``; ``dequantize`` is its fp32
case).  The kernels are ``csrc/blockwise_quant.cu``, built by
``kernels.build`` and called through their C launchers; their plain
PyTorch versions are ``kernels.ref.quantize_ref`` and
``dequantize_into_ref``, and the two sides are bitwise equal on the card.

Bound: memory -- 5 B/element for quantize from fp32 (x in, code out, plus
4/block B of scale), 3 B/element for dequantize_into to bf16 and 5 B to
fp32.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ..quant.blockwise import _check_blocking, _check_scales

KERNEL = "blockwise_quant"
# dtypes the kernels read (quantize) or write (dequantize_into)
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


def _fn(name: str, argtypes):
    fn = getattr(build.load(KERNEL), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_cuda(who: str, **tensors) -> None:
    first = next(iter(tensors.values()))
    for k, t in tensors.items():
        if not t.is_cuda or not t.is_contiguous() or t.device != first.device:
            raise ValueError(
                f"{who}: {k} must be a contiguous CUDA tensor on "
                f"{first.device}, got {t.device} "
                f"(contiguous={t.is_contiguous()})")


def _check_out(who: str, k: str, t: torch.Tensor, shape, dtype, device):
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(
            f"{who}: {k} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}")


def _raise_on(rc: int, who: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")


def quantize(x: torch.Tensor, block: int):
    """Launch the quantize kernel on a CUDA tensor ``x`` (..., n) of fp32
    or bf16 with ``n % block == 0``.  Returns ``(codes int8 like x,
    scales f32 (..., n // block))``.  Launches on the current stream
    without synchronising; a refused launch raises."""
    n = x.shape[-1]
    _check_blocking(n, block, "quantize")
    if x.dtype not in FLOAT_DTYPES:
        raise ValueError(f"quantize: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    _check_cuda("quantize", x=x)
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (n // block,), dtype=torch.float32,
                         device=x.device)
    fn = _fn("quantize_launch",
             [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(fn(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 codes.data_ptr(), scales.data_ptr(), x.numel() // block,
                 block, stream), "quantize")
    quantize.launches += 1
    return codes, scales


def dequantize_into(codes: torch.Tensor, scales: torch.Tensor, block: int,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the dequantize-into kernel: int8 ``codes`` (..., n) and f32
    ``scales`` (..., n // block) on one card -> ``out_dtype`` (fp32 or
    bf16) in one pass."""
    n = codes.shape[-1]
    _check_blocking(n, block, "dequantize")
    _check_scales(n, block, scales.shape[-1], "dequantize")
    if codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(
            f"dequantize: codes must be int8 and scales float32, got "
            f"{codes.dtype} and {scales.dtype}")
    if scales.numel() * block != codes.numel():
        raise ValueError(
            f"dequantize: {scales.numel()} scales do not cover "
            f"{codes.numel()} codes in blocks of {block}")
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"dequantize: out_dtype must be float32 or "
                         f"bfloat16, got {out_dtype}")
    _check_cuda("dequantize", codes=codes, scales=scales)
    out = torch.empty(codes.shape, dtype=out_dtype, device=codes.device)
    fn = _fn("dequantize_into_launch",
             [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    stream = torch.cuda.current_stream(codes.device).cuda_stream
    _raise_on(fn(codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                 int(out_dtype == torch.bfloat16), codes.numel() // block,
                 block, stream), "dequantize")
    dequantize_into.launches += 1
    return out


# launches of each kernel in this process (the main path's proof of route)
quantize.launches = 0
dequantize_into.launches = 0
