"""Fused optimizer step + ParamStore epilogue on the card.

Replaces two functions of ``repro/kernels/fused_update.py``:

  * ``adamw_store_update`` on its flat epilogue (``_adamw_flat_kernel`` at
    ``:85``, launched at ``:255``) and its q8_block epilogue
    (``_adamw_q8_kernel`` at ``:102``, launched at ``:198``):
    ``csrc/adamw_store_update.cu``.  Bound: memory -- 32 B/element for the
    fp32 epilogue (w, g, m, v, mask in; w', m', v' out), 30 B for bf16, 33 B
    for q8_block (plus the code, and 4/block B of scale).
  * ``adam8bit_store_update`` on its flat epilogue (``_adam8_flat_kernel``
    at ``:116``, launched at ``:337``) and its q8_block epilogue
    (``_adam8_q8_kernel`` at ``:145``, launched at ``:301``):
    ``csrc/adam8bit_store_update.cu``.  Bound: memory -- 16 B/element for
    fp32 (w, g 8 B, int8 moments 2 B in; w', m8', v8' 6 B out), 12 B for
    bf16, 17 B for q8_block, plus 16 B (20 B) of scales per quant block and
    the (S,) uint8 decay row once per call.

Each kernel is built by ``kernels.build`` and called through its C
launcher; its plain PyTorch version is in ``kernels.ref`` and the two sides
are bitwise equal on the card.  The fp8 epilogues come with ROADMAP Queue 2
item 7.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import FLAT_OUT_DTYPES, _check_block, check_store_fmt

KERNEL = "adamw_store_update"
ADAM8_KERNEL = "adam8bit_store_update"


def _launcher(name: str, argtypes, kernel: str = KERNEL):
    fn = getattr(build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(ins: dict, w) -> None:
    for k, t in ins.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"adamw_store_update: {k} must be a contiguous float32 CUDA "
                f"tensor, got {t.dtype} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
        if t.shape != w.shape or t.device != w.device:
            raise ValueError(
                f"adamw_store_update: {k} {tuple(t.shape)} on {t.device} does "
                f"not match w {tuple(w.shape)} on {w.device}")


def _check_outs(outs, w, who: str = "adamw_store_update") -> None:
    for k, t, shape, dt in outs:
        if (t.dtype != dt or tuple(t.shape) != tuple(shape)
                or t.device != w.device or not t.is_contiguous()):
            raise ValueError(
                f"{who}: {k} must be a contiguous {dt} tensor of shape "
                f"{tuple(shape)} on {w.device}")


def adamw_store_update(w, g, m, v, mask, scalars: np.ndarray, *,
                       fmt: str = "fp32", block: int = 1024, out=None):
    """Launch the fused kernel of ``fmt``'s epilogue on CUDA tensors.

    ``w, g, m, v, mask``: contiguous fp32 tensors of one shape on one card;
    ``scalars``: the 8-float vector of ``ref.scalar_stack``.  Flat
    epilogues: ``out`` is an optional ``(w_out, m_out, v_out)`` and the
    result ``(w', m', v')``.  ``fmt="q8_block"``: see ``adamw_q8_update``.
    Outputs may be the inputs themselves (``out=(w, m, v)`` updates in
    place -- the kernel reads every element before writing it).  Launches
    on the current stream without synchronising; a refused launch raises.
    """
    check_store_fmt(fmt)
    if fmt == "q8_block":
        return adamw_q8_update(w, g, m, v, mask, scalars, block=block,
                               out=out)
    _check_inputs({"w": w, "g": g, "m": m, "v": v, "mask": mask}, w)
    if out is None:
        out = (torch.empty_like(w, dtype=FLAT_OUT_DTYPES[fmt]),
               torch.empty_like(m), torch.empty_like(v))
    w_out, m_out, v_out = out
    _check_outs((("w_out", w_out, w.shape, FLAT_OUT_DTYPES[fmt]),
                 ("m_out", m_out, w.shape, torch.float32),
                 ("v_out", v_out, w.shape, torch.float32)), w)
    s = np.asarray(scalars, np.float32)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fn = _launcher("adamw_store_update_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     mask.data_ptr(), w_out.data_ptr(), m_out.data_ptr(),
                     v_out.data_ptr(), w.numel(), *(float(x) for x in s[:7]),
                     int(fmt == "bf16"), stream)
    if rc != 0:
        raise RuntimeError(
            f"adamw_store_update kernel launch failed: cudaError {rc}")
    adamw_store_update.launches += 1
    return w_out, m_out, v_out


def adamw_q8_update(w, g, m, v, mask, scalars: np.ndarray, *,
                    block: int = 1024, out=None):
    """Launch the q8_block epilogue: the AdamW step, then the blockwise
    requantize of w' (``w.shape[-1] % block == 0``, the planner's align).
    ``out``: optional ``(codes, master, scales, m_out, v_out)``; master,
    m_out and v_out may be w, m and v themselves.  Returns
    ``({"codes", "master", "scales"}, m', v')``."""
    _check_block(w.shape, block, "q8_block store update")
    _check_inputs({"w": w, "g": g, "m": m, "v": v, "mask": mask}, w)
    sshape = w.shape[:-1] + (w.shape[-1] // block,)
    if out is None:
        out = (torch.empty_like(w, dtype=torch.int8), torch.empty_like(w),
               torch.empty(sshape, dtype=torch.float32, device=w.device),
               torch.empty_like(m), torch.empty_like(v))
    codes, w_out, scales, m_out, v_out = out
    _check_outs((("codes", codes, w.shape, torch.int8),
                 ("master", w_out, w.shape, torch.float32),
                 ("scales", scales, sshape, torch.float32),
                 ("m_out", m_out, w.shape, torch.float32),
                 ("v_out", v_out, w.shape, torch.float32)), w)
    s = np.asarray(scalars, np.float32)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fn = _launcher("adamw_q8_launch",
                   [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            mask.data_ptr(), codes.data_ptr(), w_out.data_ptr(),
            scales.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
            w.numel() // block, block, *(float(x) for x in s[:7]), stream)
    if rc != 0:
        raise RuntimeError(
            f"adamw_store_update (q8_block) kernel launch failed: "
            f"cudaError {rc}")
    adamw_q8_update.launches += 1
    return {"codes": codes, "master": w_out, "scales": scales}, m_out, v_out


# the C launcher's epilogue codes (csrc/adam8bit_store_update.cu)
_ADAM8_FMT = {"fp32": 0, "bf16": 1, "q8_block": 2}
_ADAM8 = "adam8bit_store_update"


def _adam8_inputs(w, g, m8, v8, ms, vs, mask, fmt: str, block: int):
    """Check the 8-bit Adam kernel's inputs; returns the scales' shape."""
    _check_block(w.shape, block, "adam8bit store update")
    if not w.is_cuda:
        raise ValueError(f"{_ADAM8}: w must be a CUDA tensor, got one on "
                         f"{w.device}")
    sshape = w.shape[:-1] + (w.shape[-1] // block,)
    _check_outs((("w", w, w.shape, FLAT_OUT_DTYPES.get(fmt, torch.float32)),
                 ("g", g, w.shape, torch.float32),
                 ("m8", m8, w.shape, torch.int8),
                 ("v8", v8, w.shape, torch.int8),
                 ("ms", ms, sshape, torch.float32),
                 ("vs", vs, sshape, torch.float32),
                 ("mask", mask, (w.shape[-1],), torch.uint8)), w, _ADAM8)
    return sshape


def _adam8_empty_moments(m8, v8, ms, vs) -> tuple:
    return (torch.empty_like(m8), torch.empty_like(v8),
            torch.empty_like(ms), torch.empty_like(vs))


def _adam8_moment_checks(w, sshape, moments) -> tuple:
    """``_check_outs`` entries of the four moment outputs."""
    return tuple(zip(("m8_out", "v8_out", "ms_out", "vs_out"), moments,
                     (w.shape, w.shape, sshape, sshape),
                     (torch.int8, torch.int8, torch.float32, torch.float32)))


def _adam8_launch(fmt, block, w, g, m8, v8, ms, vs, mask, scalars, w_out,
                  codes, scales, moments) -> None:
    s = np.asarray(scalars, np.float32)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    fn = _launcher("adam8bit_store_update_launch",
                   [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p],
                   ADAM8_KERNEL)
    rc = fn(w.data_ptr(), g.data_ptr(), m8.data_ptr(), v8.data_ptr(),
            ms.data_ptr(), vs.data_ptr(), mask.data_ptr(), mask.numel(),
            w_out.data_ptr(), None if codes is None else codes.data_ptr(),
            None if scales is None else scales.data_ptr(),
            *(t.data_ptr() for t in moments),
            w.numel() // block, block, *(float(x) for x in s[:7]),
            _ADAM8_FMT[fmt], stream)
    if rc != 0:
        raise RuntimeError(
            f"{_ADAM8} ({fmt}) kernel launch failed: cudaError {rc}")


def adam8bit_store_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                          fmt: str = "fp32", block: int = 1024, out=None):
    """Launch the fused 8-bit Adam kernel of ``fmt``'s epilogue on CUDA
    tensors.

    ``w`` (..., S): fp32 for the fp32 and q8_block epilogues (the master),
    bf16 for bf16; ``g`` fp32 of w's shape; ``m8``, ``v8`` int8 of w's
    shape; ``ms``, ``vs`` fp32 (..., S / block); ``mask`` the (S,) uint8
    decay row shared by every row; ``S % block == 0``.  Flat epilogues:
    ``out`` is an optional ``(w_out, m8_out, v8_out, ms_out, vs_out)`` and
    the result ``(w', m8', v8', ms', vs')``.  ``fmt="q8_block"``: see
    ``adam8bit_q8_update``.  Outputs may be the inputs themselves (the
    optimizer's in-place update).  Launches on the current stream without
    synchronising; a refused launch raises."""
    check_store_fmt(fmt, _ADAM8, "Queue 2 item 7 / Queue 1 item 9")
    if fmt == "q8_block":
        return adam8bit_q8_update(w, g, m8, v8, ms, vs, mask, scalars,
                                  block=block, out=out)
    sshape = _adam8_inputs(w, g, m8, v8, ms, vs, mask, fmt, block)
    if out is None:
        out = (torch.empty_like(w),) + _adam8_empty_moments(m8, v8, ms, vs)
    w_out, *moments = out
    _check_outs((("w_out", w_out, w.shape, FLAT_OUT_DTYPES[fmt]),)
                + _adam8_moment_checks(w, sshape, moments), w, _ADAM8)
    _adam8_launch(fmt, block, w, g, m8, v8, ms, vs, mask, scalars, w_out,
                  None, None, moments)
    adam8bit_store_update.launches += 1
    return (w_out, *moments)


def adam8bit_q8_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                       block: int = 1024, out=None):
    """Launch the q8_block epilogue: the 8-bit Adam step on the fp32 master
    ``w``, then the blockwise requantize of w' (the store's block is the
    optimizer's).  ``out``: optional ``(codes, master, scales, m8_out,
    v8_out, ms_out, vs_out)``, which may be the state's own tensors.
    Returns ``({"codes", "master", "scales"}, m8', v8', ms', vs')``."""
    sshape = _adam8_inputs(w, g, m8, v8, ms, vs, mask, "q8_block", block)
    if out is None:
        out = (torch.empty_like(w, dtype=torch.int8), torch.empty_like(w),
               torch.empty(sshape, dtype=torch.float32, device=w.device)) \
            + _adam8_empty_moments(m8, v8, ms, vs)
    codes, w_out, scales, *moments = out
    _check_outs((("codes", codes, w.shape, torch.int8),
                 ("master", w_out, w.shape, torch.float32),
                 ("scales", scales, sshape, torch.float32))
                + _adam8_moment_checks(w, sshape, moments), w, _ADAM8)
    _adam8_launch("q8_block", block, w, g, m8, v8, ms, vs, mask, scalars,
                  w_out, codes, scales, moments)
    adam8bit_q8_update.launches += 1
    return ({"codes": codes, "master": w_out, "scales": scales}, *moments)


# launches of each kernel in this process (the main path's proof of route)
adamw_store_update.launches = 0
adamw_q8_update.launches = 0
adam8bit_store_update.launches = 0
adam8bit_q8_update.launches = 0
