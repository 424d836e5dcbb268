"""Plain PyTorch versions of the port's kernels: the CPU execution path and
the semantics the card's kernels are held to (the role the reference's
``interpret=True`` plays).  One eager op per step, in the reference
kernel's order; on the card every scalar is a 0-d device tensor or an
exactly representable fp32 constant, so each op rounds as the kernel's
explicitly rounded intrinsic does."""
from __future__ import annotations

import numpy as np
import torch

from ..quant.blockwise import (INV_127, SCALE_FLOOR, _blocks,
                               _check_blocking, _check_scales,
                               dequantize_blockwise, log_codes, log_values,
                               quantize_blockwise)
from .q8_matmul import check_args, fold_scales

# store epilogues of the flat AdamW update -> dtype of the written weights
FLAT_OUT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def scalar_stack(lr, b1, b2, eps, wd, c1, c2) -> np.ndarray:
    """The 8-float fp32 scalar vector of the reference's ``_scalar_stack``
    (``repro/kernels/fused_update.py:49``): lr, b1, b2, eps, wd, c1, c2, 0."""
    return np.asarray([lr, b1, b2, eps, wd, c1, c2, 0.0], np.float32)


def adamw_store_update_ref(w, g, m, v, mask, scalars: np.ndarray,
                           fmt: str = "fp32", block: int = 1024):
    """AdamW step + flat store epilogue, op for op the reference's
    ``_adam_math`` + ``_adamw_flat_kernel``, one eager op per step:

        m'  = b1*m + (1-b1)*g
        v'  = b2*v + (1-b2)*g*g
        upd = (m'/c1) / (sqrt(v'/c2) + eps)
        w'  = w - lr*(upd + wd*mask*w)

    ``scalars`` is ``scalar_stack(...)``; 1-b1 and 1-b2 are formed in
    fp32 from its entries, as the kernel does.  Returns ``(w', m', v')``
    with w' in the epilogue's dtype (fp32, or bf16 rounded to nearest
    even) and m', v' in fp32.  The ``q8_block`` epilogue (the reference's
    ``_adamw_q8_kernel``) then requantizes w' blockwise (``_requant``) and
    returns ``({"codes", "master", "scales"}, m', v')`` with master = w';
    it needs ``w.shape[-1] % block == 0``.

    PARITY vs the reference's interpreted Pallas kernel on the CPU:
    m' and v' within 1 ulp, w' within a few integer-view steps (XLA
    contracts parts of the chain; tests/test_torch_kernels.py pins the
    bound).  A q8 code inherits the class of w': it can move by one where
    w' sits within an ulp of a rounding boundary.  The CUDA kernels are
    BITWISE against this function on the card.
    """
    check_store_fmt(fmt)
    if fmt == "q8_block":
        _check_block(w.shape, block, "q8_block store update")
    w2, m2, v2 = _adam_math(w, g, m, v, mask, scalars)
    return _store_epilogue(w2, fmt, block), m2, v2


def _adam_math(w, g, m, v, mask, scalars: np.ndarray):
    """The Adam step of both updates (the reference's ``_adam_math`` /
    ``_adam8_math`` core) on fp32 moments; returns fp32 ``(w', m', v')``."""
    # 0-d tensors on w's device, not Python numbers: CUDA divides a tensor
    # by a host scalar as a multiply by its reciprocal, which is not the
    # kernel's (or the reference's) correctly rounded division
    s = torch.from_numpy(np.asarray(scalars, np.float32)).to(w.device)
    lr, b1, b2, eps, wd, c1, c2 = s[:7].unbind()
    one_m_b1, one_m_b2 = 1.0 - b1, 1.0 - b2
    g = g.float()
    m2 = b1 * m + one_m_b1 * g
    v2 = b2 * v + one_m_b2 * g * g
    upd = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
    w = w.float()
    w2 = w - lr * (upd + wd * mask * w)
    return w2, m2, v2


def _store_epilogue(w2: torch.Tensor, fmt: str, block: int):
    """The store re-encode of an updated fp32 buffer: w' in the flat
    format's dtype, or the q8 ``{"codes", "master", "scales"}`` dict."""
    if fmt == "q8_block":
        codes, scales = quantize_ref(w2, block)
        return {"codes": codes, "master": w2, "scales": scales}
    return w2.to(FLAT_OUT_DTYPES[fmt])


def adam8bit_update_ref(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray,
                        block: int):
    """The 8-bit Adam step on blockwise-quantized moments, op for op the
    reference's ``_adam8_math`` followed by the moment requantize
    (``_requant``, ``_requant_log``; ``repro/kernels/adam8bit_update.py``)::

        m  = m8 * ms                         (linear decode)
        v  = exp((v8 - 127) * f32(24/127)) * vs, 0 where v8 == 0
        w', m', v' = the AdamW step of ``adamw_store_update_ref``
        m8', ms' = quantize(m')              (absmax * f32(1/127))
        v8', vs' = log-quantize(v')          (vs' = max v' of the block)

    ``w`` (..., S) fp32 or bf16, ``g`` fp32 of w's shape, ``m8``/``v8``
    int8 of w's shape, ``ms``/``vs`` fp32 (..., S / block); ``mask`` the
    (S,) uint8 0/1 weight-decay row shared by every row of a stacked
    buffer.  Returns fp32 ``(w', m8', v8', ms', vs')``.

    PARITY vs the reference's interpreted kernel on the CPU: the log codec's
    class (``quant.blockwise``: XLA:CPU's own ``exp``/``log``) plus the
    AdamW chain's (XLA contracts ``b1*m + (1-b1)*g`` into an FMA), carried
    into the requantized moments; tests/test_torch_adam8bit.py pins the
    integer-view bounds.  The CUDA kernel is BITWISE against this function
    on the card.
    """
    _check_block(w.shape, block, "adam8bit store update")
    nb = w.shape[-1] // block
    for k, t in (("ms", ms), ("vs", vs)):
        if tuple(t.shape) != tuple(w.shape[:-1]) + (nb,):
            raise ValueError(
                f"adam8bit store update: {k} {tuple(t.shape)} must be "
                f"{tuple(w.shape[:-1]) + (nb,)} (one scale per quant block)")
    if tuple(mask.shape) != (w.shape[-1],) or mask.dtype != torch.uint8:
        raise ValueError(
            f"adam8bit store update: mask must be one uint8 row of "
            f"({w.shape[-1]},), got {mask.dtype} {tuple(mask.shape)}")
    m = dequantize_blockwise(m8, ms, block)
    v = log_values(_blocks(v8, block).float(), vs).reshape(w.shape)
    w2, m2, v2 = _adam_math(w, g, m, v, mask.float(), scalars)
    m8o, mso = quantize_blockwise(m2, block)
    vb = _blocks(v2, block)
    vso = vb.amax(dim=-1)
    v8o = log_codes(vb, vso).to(torch.int8).reshape(w.shape)
    return w2, m8o, v8o, mso, vso


def adam8bit_store_update_ref(w, g, m8, v8, ms, vs, mask,
                              scalars: np.ndarray, fmt: str = "fp32",
                              block: int = 1024):
    """8-bit Adam step + store epilogue, the reference's
    ``_adam8_flat_kernel`` (fp32, bf16) and ``_adam8_q8_kernel``
    (q8_block): ``adam8bit_update_ref``, then w' in the store's format.
    Returns ``(core, m8', v8', ms', vs')`` with ``core`` as in
    ``adamw_store_update_ref``.  PARITY: as ``adam8bit_update_ref``; a q8
    code of w' inherits w''s class (it moves by one where w' sits within
    its difference of a rounding boundary)."""
    check_store_fmt(fmt, "adam8bit_store_update", "Queue 2 item 7 / "
                    "Queue 1 item 9")
    w2, m8o, v8o, mso, vso = adam8bit_update_ref(w, g, m8, v8, ms, vs, mask,
                                                 scalars, block)
    return _store_epilogue(w2, fmt, block), m8o, v8o, mso, vso


def check_store_fmt(fmt: str, who: str = "adamw_store_update",
                    item: str = "Queue 2 item 7") -> None:
    """The epilogues the port runs: fp32, bf16 and q8_block."""
    if fmt in ("fp8_e4m3", "fp8_e5m2"):
        raise NotImplementedError(
            f"the {fmt!r} epilogue of {who} is not ported yet (ROADMAP "
            f"{item})")
    if fmt not in FLAT_OUT_DTYPES and fmt != "q8_block":
        raise ValueError(f"unknown store fmt {fmt!r} for the fused update")


def _check_block(shape, block: int, who: str) -> None:
    """The reference's ``_check_block`` (``fused_update.py:171``)."""
    if shape[-1] % block:
        raise ValueError(
            f"{who} needs last dim % block == 0, got {shape[-1]} % "
            f"{block} -- planner align missing?")


def quantize_ref(x: torch.Tensor, block: int):
    """Blockwise absmax INT8 encode, the reference's ``_quant_kernel``
    (and ``_requant``): ``(codes int8 like x, scales f32 (..., n/block))``.
    PARITY: see ``quant.blockwise`` (bitwise but for subnormal scales)."""
    _check_blocking(x.shape[-1], block, "quantize")
    return quantize_blockwise(x, block)


def dequantize_into_ref(codes: torch.Tensor, scales: torch.Tensor,
                        block: int, out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """``codes.f32 * scale`` cast to ``out_dtype`` (fp32, or bf16 rounded
    to nearest even), the reference's ``_dequant_kernel``.  PARITY:
    BITWISE."""
    n = codes.shape[-1]
    _check_blocking(n, block, "dequantize")
    _check_scales(n, block, scales.shape[-1], "dequantize")
    return dequantize_blockwise(codes, scales, block).to(out_dtype)


def encode_ef_ref(ct: torch.Tensor, ef: torch.Tensor, block: int):
    """The q8 gradient wire's encode with error feedback, the reference's
    ``_encode_ef_kernel``::

        comp   = ct.f32 + ef
        codes, scales = quantize(comp)
        new_ef = comp - codes * scale

    Returns ``(codes, scales, new_ef)``.

    PARITY vs the reference on the CPU: codes and scales BITWISE (but for
    subnormal scales, see ``quant.blockwise``); XLA contracts ``comp -
    codes*scale`` into one FMA where this function rounds the product
    first, so ``new_ef`` differs by up to half an ulp of ``codes*scale``
    plus one ulp of ``new_ef``.  The CUDA kernel is BITWISE against this
    function on the card."""
    n = ct.shape[-1]
    _check_blocking(n, block, "encode_ef")
    if ef.shape != ct.shape:
        raise ValueError(
            f"encode_ef: ef shape {tuple(ef.shape)} != ct shape "
            f"{tuple(ct.shape)}")
    comp = ct.float() + ef
    codes, scales = quantize_blockwise(comp, block)
    deq = dequantize_blockwise(codes, scales, block)
    return codes, scales, comp - deq


def q8_matmul_ref(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  block: int, out_dtype: torch.dtype | None = None
                  ) -> torch.Tensor:
    """The reference's ``_q8mm_kernel`` on tensors: ``x`` (..., K) float,
    ``codes`` (K, N) int8, ``scales`` the flat f32 block scales; returns
    (..., N) in ``out_dtype`` (default x's dtype).  Per column group j of
    the folded (nj, K) scales (``fold_scales``)::

        a   = x.f32 * s[j]                      (M, K)
        rs  = rowmax(|a|) * float32(1/127)      (what XLA compiles /127 to)
        inv = rs > 0 ? 1 / max(rs, 1e-30) : 0   (a true divide)
        a8  = clip(round_half_even(a * inv), -127, 127)
        y[:, cols_j] = f32(a8 @ codes[:, cols_j]) * rs

    The int8 products are summed in float64, exact while K * 127**2 <
    2**53 (``check_args`` caps K far below), so the f32 of the sum is the
    f32 of the kernel's exact int32 sum: one product serves both devices
    (PyTorch has no int32 matmul on CUDA).

    PARITY: BITWISE vs the reference's interpreted kernel on the CPU on
    the tests' inputs (tests/test_torch_q8_matmul.py), and the CUDA kernel
    is BITWISE against this function on the card."""
    k, n = codes.shape
    check_args(k, n, block, scales.numel())
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead = tuple(x.shape[:-1])
    xm = x.reshape(-1, k).float()
    s2 = fold_scales(scales.reshape(-1), k, n, block)   # (nj, K)
    nj = s2.shape[0]
    a = xm[None] * s2[:, None, :]                       # (nj, M, K)
    rs = a.abs().amax(dim=-1) * INV_127                 # (nj, M)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    inv = torch.where(rs > 0, one / torch.clamp(rs, min=SCALE_FLOOR),
                      torch.zeros_like(rs))
    a8 = torch.clamp(torch.round(a * inv[..., None]), -127, 127)
    w = codes.double().reshape(k, nj, n // nj).permute(1, 0, 2)
    acc = torch.bmm(a8.double(), w).float()             # (nj, M, N/nj)
    y = (acc * rs[..., None]).permute(1, 0, 2).reshape(xm.shape[0], n)
    return y.to(out_dtype).reshape(lead + (n,))
