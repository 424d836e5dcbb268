"""Block-wise linear INT8 quantization (port of the linear pair in
``repro/quant/blockwise.py``; paper section 2.1/6.3).

Symmetric INT8 with one absmax scale per block of ``block`` contiguous
elements along the last axis.  The planner's ``align`` keeps every block
inside one shard, so each rank quantizes its own shard with no
communication.  These are the plain PyTorch oracles; the hot paths go
through ``kernels.ops`` (the CUDA kernels on the card, ``kernels.ref`` on
the CPU), never through this module.  The log-space pair of 8-bit Adam's
second moment comes with ROADMAP Queue 1 item 8.

PARITY vs the reference's jitted functions: BITWISE, with one exception.
XLA:CPU flushes subnormal floats to zero, so a block whose scale
(absmax/127) is subnormal gets scale 0 there and keeps its subnormal scale
here (and on the card).  Its codes are 0 on both sides, so the decoded
values agree.
"""
from __future__ import annotations

import torch

# float32(1/127): what XLA compiles ``absmax / 127.0`` to (a multiply by the
# rounded reciprocal), and what the reference's scales therefore hold
INV_127 = float.fromhex("0x1.0204080000000p-7")
# the reference's floor under the scale before taking its reciprocal
SCALE_FLOOR = 1e-30


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
