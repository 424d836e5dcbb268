"""float8 encode of the fp8 stores and wires (the port's counterpart of the
reference's ``x.astype(float8_e4m3fn | float8_e5m2)``, with the dtypes of
``repro/compat.py`` ``float8_dtypes``).

``fp8_encode`` computes the code bits itself, with integer arithmetic that
runs the same on the CPU and on the card, instead of leaning on a library
cast: PyTorch's CPU cast saturates e4m3 at +-448, its CUDA cast is another
code path, and Hopper's ``cvt.rn.satfinite`` saturates by definition.  The
reference's rule, read from its outputs (JAX 0.9.0, ml_dtypes), is:

  * round to nearest even; e4m3 subnormals are multiples of 2^-9, e5m2's
    of 2^-16;
  * e4m3: |x| > 464 (the tie between 448 and 480 rounds to 448), +-inf and
    NaN give NaN with x's sign (``0x7f | sign``);
  * e5m2: |x| >= 61440 gives +-inf (``0x7c | sign``); NaN gives
    ``0x7e | sign`` from float32 and ``0x7f`` (no sign) from bfloat16.

The fused updates' CUDA epilogues carry the same rule
(``kernels/csrc/fp8.cuh``).  Decoding is a plain cast
(``codes.to(dtype)``): every fp8 value is exact in bf16 and fp32.

PARITY: BITWISE against the reference's ``astype`` on float32 and bfloat16
inputs, NaN codes included (tests/test_torch_fp8.py sweeps every fp8 value
and every rounding midpoint +-64 float32 ulps in both signs).
"""
from __future__ import annotations

import torch

FP8_DTYPES: dict[str, torch.dtype] = {
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}

# per format: mantissa shift of the float32 bits, exponent-bias adjustment
# ((127 - bias) << mantissa bits), float32 bits of the smallest normal,
# the subnormal step's reciprocal, the overflow threshold's float32 bits and
# the overflow code
_E4M3 = dict(shift=20, adj=960, min_normal=121 << 23, sub=512.0,
             over=0x43E80000, over_code=0x7F)          # > 464 -> NaN
_E5M2 = dict(shift=21, adj=448, min_normal=113 << 23, sub=65536.0,
             over=0x47700000, over_code=0x7C)          # >= 61440 -> inf
_INF_BITS = 0x7F800000
# elements per pass: bounds the int32 temporaries of a large buffer
_CHUNK = 1 << 26


def fp8_dtype(fmt: str) -> torch.dtype:
    if fmt not in FP8_DTYPES:
        raise ValueError(f"unknown fp8 format {fmt!r}; expected one of "
                         f"{list(FP8_DTYPES)}")
    return FP8_DTYPES[fmt]


def _codes(x: torch.Tensor, fmt: str, from_bf16: bool) -> torch.Tensor:
    """uint8 code bits of a flat float32 tensor."""
    p = _E4M3 if fmt == "fp8_e4m3" else _E5M2
    bits = x.view(torch.int32)
    sign = (bits < 0).to(torch.int32) << 7
    a = bits & 0x7FFFFFFF
    ac = torch.clamp(a, max=_INF_BITS)
    sh = p["shift"]
    normal = ((ac + ((1 << (sh - 1)) - 1) + ((ac >> sh) & 1)) >> sh) - p["adj"]
    absx = ac.view(torch.float32)
    sub = torch.round(absx * p["sub"]).to(torch.int32)
    code = torch.where(a < p["min_normal"], sub, normal)
    if fmt == "fp8_e4m3":
        code = torch.where(a > p["over"], p["over_code"], code)
        code = code | sign
    else:
        code = torch.where(a >= p["over"], p["over_code"], code) | sign
        nan = 0x7F if from_bf16 else 0x7E
        code = torch.where(a > _INF_BITS,
                           nan if from_bf16 else (sign | nan), code)
    return code.to(torch.uint8)


def fp8_encode(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` (float32 or bfloat16, any shape, on any device) as fp8 codes of
    ``fmt`` (``"fp8_e4m3"`` or ``"fp8_e5m2"``): a tensor of the float8
    dtype, x's shape, on x's device."""
    dtype = fp8_dtype(fmt)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fp8_encode: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    from_bf16 = x.dtype == torch.bfloat16
    flat = x.detach().reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.uint8, device=x.device)
    for lo in range(0, flat.numel(), _CHUNK):
        part = flat[lo:lo + _CHUNK].float().contiguous()
        out[lo:lo + _CHUNK] = _codes(part, fmt, from_bf16)
    return out.view(dtype).view(x.shape)
