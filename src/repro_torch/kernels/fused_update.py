"""Fused optimizer step + ParamStore epilogue on the card, and the two
standalone Adam updates.

Replaces six functions of the reference:

  * ``adamw_store_update`` (``repro/kernels/fused_update.py:179``) on its
    flat epilogue (``_adamw_flat_kernel`` at ``:85``, launched at ``:255``:
    ``adamw_store_update`` here), its fp8 epilogue (``_adamw_fp8_kernel``
    at ``:93``, launched at ``:242``: ``adamw_fp8_update``) and its
    q8_block epilogue (``_adamw_q8_kernel`` at ``:102``, launched at
    ``:198``: ``adamw_q8_update``), and the standalone ``adamw_update``
    (``repro/kernels/adam_update.py:37``, ``_adamw_kernel``, launched at
    ``:51``): ``csrc/adamw_store_update.cu``.  Bound: memory -- 32
    B/element for the fp32 epilogue (w, g, m, v, mask in; w', m', v' out),
    26 B for a bf16 store (bf16 w, g and w'), 33 B for fp8 (the code beside
    the fp32 master) and q8_block (plus 4/block B of scale).
  * ``adam8bit_store_update`` (``fused_update.py:268``) on its flat
    epilogue (``_adam8_flat_kernel`` at ``:116``, launched at ``:337``),
    its fp8 epilogue (``_adam8_fp8_kernel`` at ``:130``, launched at
    ``:321``: ``adam8bit_fp8_update``) and its q8_block epilogue
    (``_adam8_q8_kernel`` at ``:145``, launched at ``:301``), and the
    standalone ``adam8bit_update`` (``repro/kernels/adam8bit_update.py:70``,
    ``_adam8_kernel``, launched at ``:86``):
    ``csrc/adam8bit_store_update.cu``.  Bound: memory -- 16 B/element for
    fp32 (w, g 8 B, int8 moments 2 B in; w', m8', v8' 6 B out), 10 B for a
    bf16 store, 17 B for fp8 and q8_block, 20 B for the standalone update
    (its fp32 mask), plus 16 B (20 B) of scales per quant block and the
    (S,) uint8 decay row once per call.

Each kernel is built by ``kernels.build`` and called through its C
launcher; its plain PyTorch version is in ``kernels.ref`` and the two sides
are bitwise equal on the card.  Each wrapper counts its own launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from ..quant.fp8 import FP8_DTYPES
from .ref import FLAT_OUT_DTYPES, _check_block, _check_lanes, check_store_fmt

KERNEL = "adamw_store_update"
ADAM8_KERNEL = "adam8bit_store_update"
# the C launchers' codes of the flat and fp8 epilogues
_ADAMW_OUT = {"fp32": 0, "bf16": 1, "fp8_e4m3": 2, "fp8_e5m2": 3}
# the dtypes a weight or gradient may come in
_WG_DTYPES = (torch.float32, torch.bfloat16)
_F32 = torch.float32


def _launcher(name: str, argtypes, kernel: str = KERNEL):
    fn = getattr(build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_outs(outs, w, who: str = "adamw_store_update") -> None:
    """Each entry ``(name, tensor, shape, dtypes)``: a contiguous tensor of
    one of ``dtypes`` (a dtype or a tuple) and that shape on w's card."""
    if not w.is_cuda:
        raise ValueError(f"{who}: w must be a CUDA tensor, got one on "
                         f"{w.device}")
    for k, t, shape, dts in outs:
        dts = dts if isinstance(dts, tuple) else (dts,)
        if (t.dtype not in dts or tuple(t.shape) != tuple(shape)
                or t.device != w.device or not t.is_contiguous()):
            raise ValueError(
                f"{who}: {k} must be a contiguous "
                f"{' or '.join(map(str, dts))} tensor of shape "
                f"{tuple(shape)} on {w.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def _check_inputs(ins: dict, w, who: str = "adamw_store_update") -> None:
    """w and g fp32 or bf16, the rest fp32, all of w's shape."""
    _check_outs(tuple((k, t, w.shape, _WG_DTYPES if k in ("w", "g") else _F32)
                      for k, t in ins.items()), w, who)


def _g_scale_ptr(g_scale, w, who: str):
    """The device pointer of a 0-d fp32 gradient scale (None: no scale)."""
    if g_scale is None:
        return None
    _check_outs((("g_scale", g_scale, (), _F32),), w, who)
    return g_scale.data_ptr()


def _stream(w) -> int:
    return torch.cuda.current_stream(w.device).cuda_stream


def _raise_on(rc: int, who: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{who} kernel launch failed: cudaError {rc}")


_ADAMW_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong]
               + [ctypes.c_float] * 7 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] * 2)


def _adamw_launch(fmt, w, g, m, v, mask, scalars, w_out, codes, m_out, v_out,
                  g_scale) -> None:
    s = np.asarray(scalars, np.float32)
    fn = _launcher("adamw_store_update_launch", _ADAMW_ARGS)
    rc = fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            mask.data_ptr(), w_out.data_ptr(),
            None if codes is None else codes.data_ptr(), m_out.data_ptr(),
            v_out.data_ptr(), w.numel(), *(float(x) for x in s[:7]),
            int(w.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
            _ADAMW_OUT[fmt], _g_scale_ptr(g_scale, w, KERNEL), _stream(w))
    _raise_on(rc, f"adamw_store_update ({fmt})")


def adamw_store_update(w, g, m, v, mask, scalars: np.ndarray, *,
                       fmt: str = "fp32", block: int = 1024, out=None,
                       g_scale=None):
    """Launch the fused kernel of ``fmt``'s epilogue on CUDA tensors.

    ``w``, ``g``: fp32 or bf16 (a bf16 store passes both in bf16); ``m``,
    ``v``, ``mask``: fp32; one shape, contiguous, on one card; ``scalars``:
    the 8-float vector of ``ref.scalar_stack``; ``g_scale``: None or a 0-d
    fp32 tensor on the card the gradient is multiplied by (in fp32) before
    the step.  Flat epilogues: ``out`` is an optional ``(w_out, m_out,
    v_out)`` and the result ``(w', m', v')``.  ``fmt="fp8_*"``: see
    ``adamw_fp8_update``; ``fmt="q8_block"``: ``adamw_q8_update``.  Outputs
    may be the inputs themselves (``out=(w, m, v)`` updates in place -- the
    kernel reads every element before writing it).  Launches on the
    current stream without synchronising; a refused launch raises.
    """
    check_store_fmt(fmt)
    if fmt == "q8_block":
        if g_scale is not None:
            raise ValueError("the q8_block epilogue takes a scaled fp32 "
                             "gradient (g_scale must be None)")
        return adamw_q8_update(w, g, m, v, mask, scalars, block=block,
                               out=out)
    if fmt in FP8_DTYPES:
        return adamw_fp8_update(w, g, m, v, mask, scalars, fmt=fmt, out=out,
                                g_scale=g_scale)
    _check_inputs({"w": w, "g": g, "m": m, "v": v, "mask": mask}, w)
    if out is None:
        out = (torch.empty_like(w, dtype=FLAT_OUT_DTYPES[fmt]),
               torch.empty_like(m), torch.empty_like(v))
    w_out, m_out, v_out = out
    _check_outs((("w_out", w_out, w.shape, FLAT_OUT_DTYPES[fmt]),
                 ("m_out", m_out, w.shape, _F32),
                 ("v_out", v_out, w.shape, _F32)), w)
    _adamw_launch(fmt, w, g, m, v, mask, scalars, w_out, None, m_out, v_out,
                  g_scale)
    adamw_store_update.launches += 1
    return w_out, m_out, v_out


def adamw_fp8_update(w, g, m, v, mask, scalars: np.ndarray, *,
                     fmt: str = "fp8_e4m3", out=None, g_scale=None):
    """Launch the fp8 epilogue: the AdamW step on the fp32 master ``w``,
    writing the fp8 codes of w' (``quant.fp8`` semantics) and w' itself,
    any length.  ``out``: optional ``(codes, master, m_out, v_out)``;
    master, m_out and v_out may be w, m and v themselves.  Returns
    ``({"codes", "master"}, m', v')``."""
    _check_inputs({"w": w, "g": g, "m": m, "v": v, "mask": mask}, w,
                  "adamw_fp8_update")
    cdt = FP8_DTYPES[fmt]
    if out is None:
        out = (torch.empty_like(w, dtype=cdt), torch.empty_like(w, dtype=_F32),
               torch.empty_like(m), torch.empty_like(v))
    codes, w_out, m_out, v_out = out
    _check_outs((("w", w, w.shape, _F32),
                 ("codes", codes, w.shape, cdt),
                 ("master", w_out, w.shape, _F32),
                 ("m_out", m_out, w.shape, _F32),
                 ("v_out", v_out, w.shape, _F32)), w, "adamw_fp8_update")
    _adamw_launch(fmt, w, g, m, v, mask, scalars, w_out, codes, m_out, v_out,
                  g_scale)
    adamw_fp8_update.launches += 1
    return {"codes": codes, "master": w_out}, m_out, v_out


def adamw_update(w, g, m, v, mask, scalars: np.ndarray, *, out=None):
    """The standalone AdamW update (the reference's ``adamw_update``): fp32
    ``w, g, m, v, mask`` of n % 128 == 0 elements (any shape), the full
    decay mask read per element; returns fp32 ``(w', m', v')``, into
    ``out=(w_out, m_out, v_out)`` when given (which may be the inputs)."""
    _check_lanes(w, "adamw_update")
    _check_outs(tuple((k, t, w.shape, _F32) for k, t in
                      (("w", w), ("g", g), ("m", m), ("v", v),
                       ("mask", mask))), w, "adamw_update")
    if out is None:
        out = (torch.empty_like(w), torch.empty_like(m), torch.empty_like(v))
    _check_outs(tuple((k, t, w.shape, _F32) for k, t in
                      zip(("w_out", "m_out", "v_out"), out)), w,
                "adamw_update")
    w_out, m_out, v_out = out
    s = np.asarray(scalars, np.float32)
    fn = _launcher("adamw_update_launch",
                   [ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    _raise_on(fn(w.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                 mask.data_ptr(), w_out.data_ptr(), m_out.data_ptr(),
                 v_out.data_ptr(), w.numel(), *(float(x) for x in s[:7]),
                 _stream(w)), "adamw_update")
    adamw_update.launches += 1
    return w_out, m_out, v_out


def adamw_q8_update(w, g, m, v, mask, scalars: np.ndarray, *,
                    block: int = 1024, out=None):
    """Launch the q8_block epilogue: the AdamW step, then the blockwise
    requantize of w' (``w.shape[-1] % block == 0``, the planner's align).
    ``out``: optional ``(codes, master, scales, m_out, v_out)``; master,
    m_out and v_out may be w, m and v themselves.  Returns
    ``({"codes", "master", "scales"}, m', v')``."""
    _check_block(w.shape, block, "q8_block store update")
    _check_outs(tuple((k, t, w.shape, _F32) for k, t in
                      (("w", w), ("g", g), ("m", m), ("v", v),
                       ("mask", mask))), w)
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
_ADAM8_FMT = {"fp32": 0, "bf16": 1, "q8_block": 2, "fp8_e4m3": 3,
              "fp8_e5m2": 4}
_ADAM8 = "adam8bit_store_update"


def _adam8_inputs(w, g, m8, v8, ms, vs, mask, fmt: str, block: int):
    """Check the 8-bit Adam kernel's inputs; returns the scales' shape."""
    _check_block(w.shape, block, "adam8bit store update")
    if not w.is_cuda:
        raise ValueError(f"{_ADAM8}: w must be a CUDA tensor, got one on "
                         f"{w.device}")
    sshape = w.shape[:-1] + (w.shape[-1] // block,)
    _check_outs((("w", w, w.shape, FLAT_OUT_DTYPES.get(fmt, _F32)),
                 ("g", g, w.shape, _WG_DTYPES),
                 ("m8", m8, w.shape, torch.int8),
                 ("v8", v8, w.shape, torch.int8),
                 ("ms", ms, sshape, _F32),
                 ("vs", vs, sshape, _F32),
                 ("mask", mask, (w.shape[-1],), torch.uint8)), w, _ADAM8)
    return sshape


def _adam8_empty_moments(m8, v8, ms, vs) -> tuple:
    return (torch.empty_like(m8), torch.empty_like(v8),
            torch.empty_like(ms), torch.empty_like(vs))


def _adam8_moment_checks(w, sshape, moments) -> tuple:
    """``_check_outs`` entries of the four moment outputs."""
    return tuple(zip(("m8_out", "v8_out", "ms_out", "vs_out"), moments,
                     (w.shape, w.shape, sshape, sshape),
                     (torch.int8, torch.int8, _F32, _F32)))


def _adam8_launch(fmt, block, w, g, m8, v8, ms, vs, mask, scalars, w_out,
                  codes, scales, moments, g_scale) -> None:
    s = np.asarray(scalars, np.float32)
    fn = _launcher("adam8bit_store_update_launch",
                   [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2, ADAM8_KERNEL)
    rc = fn(w.data_ptr(), g.data_ptr(), m8.data_ptr(), v8.data_ptr(),
            ms.data_ptr(), vs.data_ptr(), mask.data_ptr(), mask.numel(),
            w_out.data_ptr(), None if codes is None else codes.data_ptr(),
            None if scales is None else scales.data_ptr(),
            *(t.data_ptr() for t in moments),
            w.numel() // block, block, *(float(x) for x in s[:7]),
            _ADAM8_FMT[fmt], int(g.dtype == torch.bfloat16),
            _g_scale_ptr(g_scale, w, _ADAM8), _stream(w))
    _raise_on(rc, f"{_ADAM8} ({fmt})")


def adam8bit_store_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                          fmt: str = "fp32", block: int = 1024, out=None,
                          g_scale=None):
    """Launch the fused 8-bit Adam kernel of ``fmt``'s epilogue on CUDA
    tensors.

    ``w`` (..., S): bf16 for the bf16 epilogue, else fp32 (the master);
    ``g`` fp32 or bf16 of w's shape, times ``g_scale`` (None or a 0-d fp32
    tensor on the card) in fp32; ``m8``, ``v8`` int8 of w's shape; ``ms``,
    ``vs`` fp32 (..., S / block); ``mask`` the (S,) uint8 decay row shared
    by every row; ``S % block == 0``.  Flat epilogues: ``out`` is an
    optional ``(w_out, m8_out, v8_out, ms_out, vs_out)`` and the result
    ``(w', m8', v8', ms', vs')``.  ``fmt="fp8_*"``: see
    ``adam8bit_fp8_update``; ``fmt="q8_block"``: ``adam8bit_q8_update``.
    Outputs may be the inputs themselves (the optimizer's in-place update).
    Launches on the current stream without synchronising; a refused launch
    raises."""
    check_store_fmt(fmt)
    if fmt == "q8_block":
        return adam8bit_q8_update(w, g, m8, v8, ms, vs, mask, scalars,
                                  block=block, out=out, g_scale=g_scale)
    if fmt in FP8_DTYPES:
        return adam8bit_fp8_update(w, g, m8, v8, ms, vs, mask, scalars,
                                   fmt=fmt, block=block, out=out,
                                   g_scale=g_scale)
    sshape = _adam8_inputs(w, g, m8, v8, ms, vs, mask, fmt, block)
    if out is None:
        out = (torch.empty_like(w),) + _adam8_empty_moments(m8, v8, ms, vs)
    w_out, *moments = out
    _check_outs((("w_out", w_out, w.shape, FLAT_OUT_DTYPES[fmt]),)
                + _adam8_moment_checks(w, sshape, moments), w, _ADAM8)
    _adam8_launch(fmt, block, w, g, m8, v8, ms, vs, mask, scalars, w_out,
                  None, None, moments, g_scale)
    adam8bit_store_update.launches += 1
    return (w_out, *moments)


def _adam8_coded(fmt, code_dtype, scaled: bool, w, g, m8, v8, ms, vs, mask,
                 scalars, block, out, g_scale):
    """The epilogues that write codes beside the fp32 master (fp8, and
    q8_block with its scales)."""
    sshape = _adam8_inputs(w, g, m8, v8, ms, vs, mask, fmt, block)
    head = (torch.empty_like(w, dtype=code_dtype), torch.empty_like(w)) \
        + ((torch.empty(sshape, dtype=_F32, device=w.device),)
           if scaled else ())
    if out is None:
        out = head + _adam8_empty_moments(m8, v8, ms, vs)
    k = len(head)
    codes, w_out = out[:2]
    scales = out[2] if scaled else None
    moments = out[k:]
    _check_outs((("codes", codes, w.shape, code_dtype),
                 ("master", w_out, w.shape, _F32))
                + ((("scales", scales, sshape, _F32),) if scaled else ())
                + _adam8_moment_checks(w, sshape, moments), w, _ADAM8)
    _adam8_launch(fmt, block, w, g, m8, v8, ms, vs, mask, scalars, w_out,
                  codes, scales, moments, g_scale)
    core = {"codes": codes, "master": w_out}
    if scaled:
        core["scales"] = scales
    return (core, *moments)


def adam8bit_fp8_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                        fmt: str = "fp8_e4m3", block: int = 1024, out=None,
                        g_scale=None):
    """Launch the fp8 epilogue: the 8-bit Adam step on the fp32 master
    ``w``, writing the fp8 codes of w' and w' itself.  ``out``: optional
    ``(codes, master, m8_out, v8_out, ms_out, vs_out)``, which may be the
    state's own tensors.  Returns ``({"codes", "master"}, m8', v8', ms',
    vs')``."""
    res = _adam8_coded(fmt, FP8_DTYPES[fmt], False, w, g, m8, v8, ms, vs,
                       mask, scalars, block, out, g_scale)
    adam8bit_fp8_update.launches += 1
    return res


def adam8bit_q8_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                       block: int = 1024, out=None, g_scale=None):
    """Launch the q8_block epilogue: the 8-bit Adam step on the fp32 master
    ``w``, then the blockwise requantize of w' (the store's block is the
    optimizer's).  ``out``: optional ``(codes, master, scales, m8_out,
    v8_out, ms_out, vs_out)``, which may be the state's own tensors.
    Returns ``({"codes", "master", "scales"}, m8', v8', ms', vs')``."""
    res = _adam8_coded("q8_block", torch.int8, True, w, g, m8, v8, ms, vs,
                       mask, scalars, block, out, g_scale)
    adam8bit_q8_update.launches += 1
    return res


def adam8bit_update(w, g, m8, v8, ms, vs, mask, scalars: np.ndarray, *,
                    block: int = 1024, out=None):
    """The standalone 8-bit Adam update (the reference's
    ``adam8bit_update``): fp32 ``w``, ``g`` and full-size ``mask`` of n
    elements (any shape, n % block == 0), int8 ``m8``, ``v8`` of w's shape,
    fp32 ``ms``, ``vs`` of n / block; returns fp32 w' and the new moments
    ``(w', m8', v8', ms', vs')`` with the inputs' shapes, into ``out`` when
    given (which may be the inputs)."""
    n = w.numel()
    if block < 1 or n % block:
        raise ValueError(f"adam8bit_update needs n % block == 0, got {n} % "
                         f"{block}")
    nb = n // block
    _check_outs((("w", w, w.shape, _F32), ("g", g, w.shape, _F32),
                 ("m8", m8, w.shape, torch.int8),
                 ("v8", v8, w.shape, torch.int8),
                 ("ms", ms, ms.shape, _F32), ("vs", vs, ms.shape, _F32),
                 ("mask", mask, w.shape, _F32)), w, "adam8bit_update")
    if ms.numel() != nb:
        raise ValueError(f"adam8bit_update: {ms.numel()} scales for {nb} "
                         f"quant blocks")
    if out is None:
        out = (torch.empty_like(w),) + _adam8_empty_moments(m8, v8, ms, vs)
    _check_outs(tuple(zip(("w_out", "m8_out", "v8_out", "ms_out", "vs_out"),
                          out, (w.shape, w.shape, w.shape, ms.shape,
                                ms.shape),
                          (_F32, torch.int8, torch.int8, _F32, _F32))), w,
                "adam8bit_update")
    s = np.asarray(scalars, np.float32)
    fn = _launcher("adam8bit_update_launch",
                   [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_float] * 7 + [ctypes.c_void_p], ADAM8_KERNEL)
    _raise_on(fn(w.data_ptr(), g.data_ptr(), m8.data_ptr(), v8.data_ptr(),
                 ms.data_ptr(), vs.data_ptr(), mask.data_ptr(),
                 *(t.data_ptr() for t in out), nb, block,
                 *(float(x) for x in s[:7]), _stream(w)), "adam8bit_update")
    adam8bit_update.launches += 1
    return tuple(out)


# launches of each kernel in this process (the main path's proof of route)
adamw_store_update.launches = 0
adamw_fp8_update.launches = 0
adamw_q8_update.launches = 0
adamw_update.launches = 0
adam8bit_store_update.launches = 0
adam8bit_fp8_update.launches = 0
adam8bit_q8_update.launches = 0
adam8bit_update.launches = 0
