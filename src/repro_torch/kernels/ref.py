"""Plain PyTorch versions of the port's kernels: the CPU execution path and
the semantics the card's kernels are held to (the role the reference's
``interpret=True`` plays)."""
from __future__ import annotations

import numpy as np
import torch

# store epilogues of the flat AdamW update -> dtype of the written weights
FLAT_OUT_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def scalar_stack(lr, b1, b2, eps, wd, c1, c2) -> np.ndarray:
    """The 8-float fp32 scalar vector of the reference's ``_scalar_stack``
    (``repro/kernels/fused_update.py:49``): lr, b1, b2, eps, wd, c1, c2, 0."""
    return np.asarray([lr, b1, b2, eps, wd, c1, c2, 0.0], np.float32)


def adamw_store_update_ref(w, g, m, v, mask, scalars: np.ndarray,
                           fmt: str = "fp32"):
    """AdamW step + flat store epilogue, op for op the reference's
    ``_adam_math`` + ``_adamw_flat_kernel``, one eager op per step:

        m'  = b1*m + (1-b1)*g
        v'  = b2*v + (1-b2)*g*g
        upd = (m'/c1) / (sqrt(v'/c2) + eps)
        w'  = w - lr*(upd + wd*mask*w)

    ``scalars`` is ``scalar_stack(...)``; 1-b1 and 1-b2 are formed in
    fp32 from its entries, as the kernel does.  Returns ``(w', m', v')``
    with w' in the epilogue's dtype (fp32, or bf16 rounded to nearest
    even) and m', v' in fp32.

    PARITY vs the reference's interpreted Pallas kernel on the CPU:
    m' and v' within 1 ulp, w' within a few integer-view steps (XLA
    contracts parts of the chain; tests/test_torch_kernels.py pins the
    bound).  The CUDA kernel is BITWISE against this function on the card.
    """
    if fmt not in FLAT_OUT_DTYPES:
        raise NotImplementedError(
            f"the {fmt!r} epilogue of adamw_store_update is not ported yet "
            f"(ROADMAP Queue 2)")
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
    return w2.to(FLAT_OUT_DTYPES[fmt]), m2, v2
