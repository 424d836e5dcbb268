"""Block-wise INT8 quantization (port of ``repro/quant/blockwise.py``;
paper section 2.1/6.3): the linear pair and the log-space pair of 8-bit
Adam's second moment.

Symmetric INT8 with one absmax scale per block of ``block`` contiguous
elements along the last axis.  The planner's ``align`` keeps every block
inside one shard, so each rank quantizes its own shard with no
communication.  These are the plain PyTorch oracles; the hot paths go
through ``kernels.ops`` (the CUDA kernels on the card, ``kernels.ref`` on
the CPU), never through this module.

PARITY vs the reference's jitted functions:
  * linear pair: BITWISE, with one exception.  XLA:CPU flushes subnormal
    floats to zero, so a block whose scale (absmax/127) is subnormal gets
    scale 0 there and keeps its subnormal scale here (and on the card).
    Its codes are 0 on both sides, so the decoded values agree.
  * log pair: ALLCLOSE.  The port computes what XLA compiles the source
    to (``(c - 127) * float32(24/127)`` and ``log(.) * float32(1/24)``),
    but XLA:CPU's ``exp`` and ``log`` are its own approximations: a decoded
    value differs by up to 30 integer-view steps (codes 8-9 and 24-30 of
    the 127, measured exhaustively in tests/test_torch_adam8bit.py) and a
    code moves by one where its log lands within that error of a rounding
    boundary.  XLA:CPU also flushes the subnormal floor 1e-38 (and
    subnormal absmaxes) to zero; zero inputs still give code 0.
"""
from __future__ import annotations

import torch

# float32(1/127): what XLA compiles ``absmax / 127.0`` to (a multiply by the
# rounded reciprocal), and what the reference's scales therefore hold
INV_127 = float.fromhex("0x1.0204080000000p-7")
# the reference's floor under the scale before taking its reciprocal
SCALE_FLOOR = 1e-30

# log-space codec: codes 1..127 decode to absmax * exp((c - 127)/127 * 24)
RANGE_NATS = 24.0  # ~1e-10 relative dynamic range, ~19% relative resolution
# float32(24/127): XLA folds ``(c - 127) / 127 * 24`` into one multiply
LOG_STEP = float.fromhex("0x1.83060c0000000p-3")
# float32(1/24): what XLA compiles ``log(.) / RANGE_NATS`` to
INV_RANGE = float.fromhex("0x1.5555560000000p-5")
# the reference's floor under the absmax and the ratio (subnormal in fp32)
LOG_FLOOR = 1e-38


def _check_blocking(n: int, block: int, who: str) -> None:
    """The blocking contract (ValueError, so it survives ``python -O``),
    shared with the kernel wrappers so that both raise the same text."""
    if block < 1:
        raise ValueError(f"{who}: block must be >= 1, got {block}")
    if n % block != 0:
        raise ValueError(
            f"{who}: last dim {n} not divisible by block {block}")


def _check_scales(n: int, block: int, scales_last: int, who: str) -> None:
    """The dequantize-side half of the contract: one scale per block."""
    if scales_last != n // block:
        raise ValueError(
            f"{who}: scales last dim {scales_last} != "
            f"{n // block} blocks")


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[-1]
    return x.reshape(x.shape[:-1] + (n // block, block))


def quantize_blockwise(x: torch.Tensor, block: int):
    """x: (..., n) float, n % block == 0.  Returns (codes int8 (..., n),
    scales f32 (..., n // block))::

        scale = absmax * float32(1/127)
        codes = clip(round_half_even(x * inv), -127, 127),
        inv   = 1 / max(scale, 1e-30) where scale > 0, else 0
    """
    n = x.shape[-1]
    _check_blocking(n, block, "quantize_blockwise")
    xb = _blocks(x, block).float()
    scale = xb.abs().amax(dim=-1) * INV_127
    one = torch.ones((), dtype=torch.float32, device=x.device)
    inv = torch.where(scale > 0, one / torch.clamp(scale, min=SCALE_FLOOR),
                      torch.zeros_like(scale))
    codes = torch.clamp(torch.round(xb * inv[..., None]), -127, 127)
    return codes.to(torch.int8).reshape(x.shape), scale


def dequantize_blockwise(codes: torch.Tensor, scales: torch.Tensor,
                         block: int) -> torch.Tensor:
    """codes int8 (..., n), scales f32 (..., n // block) -> f32 (..., n)."""
    n = codes.shape[-1]
    _check_blocking(n, block, "dequantize_blockwise")
    _check_scales(n, block, scales.shape[-1], "dequantize_blockwise")
    out = _blocks(codes, block).float() * scales[..., None]
    return out.reshape(codes.shape)


# ---------------------------------------------------------------------------
# log-space quantization for non-negative, high-dynamic-range states (Adam's
# second moment): linear int8 underflows v to 0 inside blocks whose absmax is
# far above the typical entry, which explodes m / (sqrt(v) + eps).
# codes: 0 == exact zero; 1..127 == absmax * exp((q - 127)/127 * RANGE_NATS).
# ---------------------------------------------------------------------------

def log_codes(xb: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """fp32 codes (integral, in [0, 127]) of non-negative fp32 blocks ``xb``
    (..., nb, block) with per-block ``absmax`` (..., nb)::

        safe = x / max(absmax, 1e-38)
        code = round_half_even(127 * (1 + log(max(safe, 1e-38)) * f32(1/24)))
        code = clip(code, 1, 127) where x > 0, else 0
    """
    safe = xb / torch.clamp(absmax, min=LOG_FLOOR)[..., None]
    logq = torch.log(torch.clamp(safe, min=LOG_FLOOR)) * INV_RANGE
    codes = torch.round(127.0 * (1.0 + logq))
    return torch.where(xb > 0, torch.clamp(codes, 1.0, 127.0),
                       torch.zeros((), dtype=codes.dtype, device=xb.device))


def log_values(cb: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """fp32 values of fp32 codes ``cb`` (..., nb, block) with per-block
    ``scales`` (..., nb): ``exp((c - 127) * f32(24/127)) * scale`` where
    c > 0, else 0."""
    val = torch.exp((cb - 127.0) * LOG_STEP) * scales[..., None]
    return torch.where(cb > 0, val,
                       torch.zeros((), dtype=val.dtype, device=cb.device))


def quantize_blockwise_log(x: torch.Tensor, block: int):
    """x >= 0, (..., n), n % block == 0.  Returns (codes int8 in [0, 127]
    (..., n), scales f32 (..., n // block)); the scale is the block's max."""
    n = x.shape[-1]
    _check_blocking(n, block, "quantize_blockwise_log")
    xb = _blocks(x, block).float()
    absmax = xb.amax(dim=-1)
    return log_codes(xb, absmax).to(torch.int8).reshape(x.shape), absmax


def dequantize_blockwise_log(codes: torch.Tensor, scales: torch.Tensor,
                             block: int) -> torch.Tensor:
    """codes int8 (..., n), scales f32 (..., n // block) -> f32 (..., n)."""
    n = codes.shape[-1]
    _check_blocking(n, block, "dequantize_blockwise_log")
    _check_scales(n, block, scales.shape[-1], "dequantize_blockwise_log")
    return log_values(_blocks(codes, block).float(),
                      scales).reshape(codes.shape)
