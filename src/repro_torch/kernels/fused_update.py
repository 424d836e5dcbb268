"""Fused AdamW step + ParamStore epilogue on the card.

Replaces ``repro/kernels/fused_update.py::adamw_store_update`` on its flat
epilogue (``_adamw_flat_kernel`` at ``fused_update.py:85``, launched at
``:255``) and its q8_block epilogue (``_adamw_q8_kernel`` at ``:102``,
launched at ``:198``).  Both kernels are in ``csrc/adamw_store_update.cu``,
built by ``kernels.build`` and called through their C launchers; their
plain PyTorch version is ``kernels.ref.adamw_store_update_ref`` and the
two sides are bitwise equal on the card.

Bound: memory -- 32 B/element for the fp32 epilogue (w, g, m, v, mask in;
w', m', v' out), 30 B for bf16, 33 B for q8_block (plus the code, and
4/block B of scale), each byte moved once.  The fp8 epilogue comes with
ROADMAP Queue 2 item 7.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import FLAT_OUT_DTYPES, _check_block, check_store_fmt

KERNEL = "adamw_store_update"


def _launcher(name: str, argtypes):
    fn = getattr(build.load(KERNEL), name)
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


def _check_outs(outs, w) -> None:
    for k, t, shape, dt in outs:
        if (t.dtype != dt or tuple(t.shape) != tuple(shape)
                or t.device != w.device or not t.is_contiguous()):
            raise ValueError(
                f"adamw_store_update: {k} must be a contiguous {dt} tensor "
                f"of shape {tuple(shape)} on {w.device}")


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


# launches of each kernel in this process (the main path's proof of route)
adamw_store_update.launches = 0
adamw_q8_update.launches = 0
