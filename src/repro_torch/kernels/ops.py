"""The dispatch layer for the port's kernels (port of
``repro/kernels/ops.py`` for the ops the slice runs).

Rule: CUDA tensors launch the hand-written kernel; CPU tensors take the
plain PyTorch version (``kernels.ref``), the CPU tests' path; anything
else -- tensors split across devices, another device type -- raises.
There is no fallback from a failed build or launch to the plain version.
"""
from __future__ import annotations

import torch

from . import fused_update
from .ref import adamw_store_update_ref, scalar_stack


def _device_kind(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    devices = {t.device for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len(devices) == 1:
        return "cuda"
    raise ValueError(
        f"kernel inputs must all lie on the CPU or all on one CUDA device, "
        f"got {sorted(str(d) for d in devices)}")


def adamw_store_update(w, g, m, v, mask, *, lr, b1, b2, eps, wd, c1, c2,
                       fmt: str = "fp32", out=None):
    """Fused AdamW step + flat store epilogue (fp32 or bf16 weights).
    Returns ``(w', m', v')``; ``out=(w, m, v)`` updates in place (the
    optimizer's main path, which saves three transient copies of the
    state).

    PARITY: the CUDA kernel is BITWISE against the plain version on the
    card; the plain version is within a few ulp of the reference's
    interpreted kernel (see ``kernels.ref``)."""
    scalars = scalar_stack(lr, b1, b2, eps, wd, c1, c2)
    if _device_kind(w, g, m, v, mask) == "cuda":
        return fused_update.adamw_store_update(w, g, m, v, mask, scalars,
                                               fmt=fmt, out=out)
    w2, m2, v2 = adamw_store_update_ref(w, g, m, v, mask, scalars, fmt)
    if out is None:
        return w2, m2, v2
    for dst, src in zip(out, (w2, m2, v2)):
        dst.copy_(src)
    return out
