"""Fused q8 gradient-wire encode with error feedback on the card.

Replaces ``repro/kernels/encode_ef.py::encode_ef`` (``_encode_ef_kernel``,
launched at ``:66``).  The kernel is ``csrc/encode_ef.cu``, built by
``kernels.build`` and called through its C launcher; its plain PyTorch
version is ``kernels.ref.encode_ef_ref`` and the two are bitwise equal on
the card.

Bound: memory -- 11 B/element for a bf16 cotangent (ct 2 B and ef 4 B in;
code 1 B and new_ef 4 B out; 4/block B of scale), 13 B for fp32.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .blockwise_quant import FLOAT_DTYPES, _check_cuda, _check_out, _raise_on
from ..quant.blockwise import _check_blocking

KERNEL = "encode_ef"


def _launcher():
    fn = build.load(KERNEL).encode_ef_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def encode_ef(ct: torch.Tensor, ef: torch.Tensor, block: int, *, out=None):
    """Launch the kernel: ``ct`` (..., n) fp32 or bf16 and ``ef`` fp32 of
    the same shape, on one card, ``n % block == 0``.  Returns ``(codes
    int8, scales f32 (..., n // block), new_ef f32)``, written into
    ``out=(codes, scales, new_ef)`` when given; ``new_ef`` may be ``ef``
    itself (the residual updated in place)."""
    n = ct.shape[-1]
    _check_blocking(n, block, "encode_ef")
    if ef.shape != ct.shape:
        raise ValueError(
            f"encode_ef: ef shape {tuple(ef.shape)} != ct shape "
            f"{tuple(ct.shape)}")
    if ct.dtype not in FLOAT_DTYPES or ef.dtype != torch.float32:
        raise ValueError(
            f"encode_ef: ct must be float32 or bfloat16 and ef float32, got "
            f"{ct.dtype} and {ef.dtype}")
    _check_cuda("encode_ef", ct=ct, ef=ef)
    dev = ct.device
    sshape = ct.shape[:-1] + (n // block,)
    if out is None:
        out = (torch.empty(ct.shape, dtype=torch.int8, device=dev),
               torch.empty(sshape, dtype=torch.float32, device=dev),
               torch.empty(ct.shape, dtype=torch.float32, device=dev))
    codes, scales, new_ef = out
    _check_out("encode_ef", "codes", codes, ct.shape, torch.int8, dev)
    _check_out("encode_ef", "scales", scales, sshape, torch.float32, dev)
    _check_out("encode_ef", "new_ef", new_ef, ct.shape, torch.float32, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_launcher()(ct.data_ptr(), int(ct.dtype == torch.bfloat16),
                          ef.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                          new_ef.data_ptr(), ct.numel() // block, block,
                          stream), "encode_ef")
    encode_ef.launches += 1
    return codes, scales, new_ef


# launches of the kernel in this process (the main path's proof of route)
encode_ef.launches = 0
