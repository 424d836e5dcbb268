"""Fused AdamW step + flat ParamStore epilogue on the card.

Replaces ``repro/kernels/fused_update.py::adamw_store_update`` on its flat
epilogue (``_adamw_flat_kernel`` at ``fused_update.py:85``, launched at
``:255``).  The kernel is ``csrc/adamw_store_update.cu``, built by
``kernels.build`` and called through its C launcher; its plain PyTorch
version is ``kernels.ref.adamw_store_update_ref`` and the two are bitwise
equal on the card.

Bound: memory -- 32 B/element for the fp32 epilogue (w, g, m, v, mask in;
w', m', v' out), 30 B for bf16, each byte moved once.  The fp8 and q8
epilogues come with ROADMAP Queue 2.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .ref import FLAT_OUT_DTYPES

KERNEL = "adamw_store_update"


def _launcher():
    fn = build.load(KERNEL).adamw_store_update_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def adamw_store_update(w, g, m, v, mask, scalars: np.ndarray, *,
                       fmt: str = "fp32", out=None):
    """Launch the fused kernel on CUDA tensors.

    ``w, g, m, v, mask``: contiguous fp32 tensors of one shape on one card;
    ``scalars``: the 8-float vector of ``ref.scalar_stack``.  ``out``:
    optional ``(w_out, m_out, v_out)``; they may be the inputs themselves
    (``out=(w, m, v)`` updates in place -- the kernel reads every element
    before writing it).  Returns ``(w', m', v')``.  Launches on the current
    stream without synchronising; a refused launch raises.
    """
    if fmt not in FLAT_OUT_DTYPES:
        raise NotImplementedError(
            f"the {fmt!r} epilogue of adamw_store_update is not ported yet "
            f"(ROADMAP Queue 2)")
    ins = {"w": w, "g": g, "m": m, "v": v, "mask": mask}
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
    if out is None:
        out = (torch.empty_like(w, dtype=FLAT_OUT_DTYPES[fmt]),
               torch.empty_like(m), torch.empty_like(v))
    w_out, m_out, v_out = out
    for k, t, dt in (("w_out", w_out, FLAT_OUT_DTYPES[fmt]),
                     ("m_out", m_out, torch.float32),
                     ("v_out", v_out, torch.float32)):
        if (t.dtype != dt or t.shape != w.shape or t.device != w.device
                or not t.is_contiguous()):
            raise ValueError(
                f"adamw_store_update: {k} must be a contiguous {dt} tensor "
                f"of shape {tuple(w.shape)} on {w.device}")
    s = np.asarray(scalars, np.float32)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = _launcher()(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     mask.data_ptr(), w_out.data_ptr(), m_out.data_ptr(),
                     v_out.data_ptr(), w.numel(), *(float(x) for x in s[:7]),
                     int(fmt == "bf16"), stream)
    if rc != 0:
        raise RuntimeError(
            f"adamw_store_update kernel launch failed: cudaError {rc}")
    adamw_store_update.launches += 1
    return w_out, m_out, v_out


# launches of the kernel in this process (the main path's proof of route)
adamw_store_update.launches = 0
