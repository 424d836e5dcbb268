"""Distributed Muon via layer-axis redistribution (port of
``repro/optim/muon.py``; paper section 6.3, Algorithm 2).

Muon's Newton-Schulz preconditioner needs each 2-D parameter as its whole
matrix.  The paper redistributes each tensor to a load-balanced root rank,
runs Newton-Schulz there and redistributes back; the reference's SPMD form,
kept here, lets the layer axis of a stacked group play the root: the
Nesterov momentum ``(L, S)`` is all-gathered along the shard axis into the
group's ``(L, m * S)`` buffer, L is padded to ``Lp = ceil(L / m) * m``, each
rank orthogonalizes its ``Lp / m`` whole matrices of every 2-D placement,
and the results are all-gathered along the layer axis and scattered back
into the flat update, of which each rank keeps its shard.  The collectives
are ``all_gather_into_tensor`` on the runtime's group (gloo on the CPU,
NCCL on the card).

Non-2-D parameters and unstacked groups (embeddings, head, norms) take the
AdamW fallback; a stacked group with 2-D placements takes the masked blend
``mask * muon + (1 - mask) * adam``.  The momentum ``mom`` is updated for
every group, the unstacked ones too, where it is unused, so the state
carried across is the reference's.  The elementwise chain runs over column
chunks of the shard (``common.pieces``) in the reference's order, so no
group-sized fp32 intermediate exists (qwen2.5-14b's ``globals`` group is
1.557 G elements: 6.2 GB for each one XLA would fuse away).

PARITY: ALLCLOSE.  Newton-Schulz is plain ``torch.matmul`` in fp32 with
TF32 off, as the reference computes it outside any kernel; its sums run in
another order than XLA's, and the iteration amplifies those last-bit
differences (tests/test_torch_optim.py states the bounds).  The Adam
fallback carries the AdamW class (XLA may contract a product and a sum into
one FMA where the port rounds both).
"""
from __future__ import annotations

import numpy as np
import torch

from .common import (OptimizerBase, adam_direction, grad_f32, has_matrices,
                     mask_rows, pieces, redistribute, write_decayed)

_NS_COEFFS = (3.4445, -4.7750, 2.0315)


def newton_schulz(G: torch.Tensor, steps: int = 5,
                  eps: float = 1e-7) -> torch.Tensor:
    """Matrix-sign iteration on ``G`` (a, b) or a batch (l, a, b), any
    aspect: Frobenius-normalized (plus ``eps``), transposed when tall, five
    quintic steps ``X <- a X + (b A + c A A) X`` with ``A = X X^T``."""
    a, b, c = _NS_COEFFS
    transpose = G.shape[-2] > G.shape[-1]
    X = G.mT if transpose else G
    X = X / (torch.linalg.vector_norm(X, dim=(-2, -1), keepdim=True) + eps)
    for _ in range(steps):
        A = X @ X.mT
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return (X.mT if transpose else X).to(G.dtype)


def muon_scale(a: int, b: int) -> float:
    """``sqrt(max(1, a / b))`` in float32, as the reference computes it (a
    weakly typed fp32 scalar)."""
    return float(np.sqrt(np.float32(max(1.0, a / b))))


class Muon(OptimizerBase):
    mu = 0.95
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1

    def __init__(self, cfg):
        super().__init__(cfg)
        self._masks: dict[str, torch.Tensor] = {}

    def init(self, runtime):
        """Zero ``mom``, ``m``, ``v`` and this rank's mask rows."""
        self.check_no_outer(runtime)
        self._masks = mask_rows(runtime)
        return self.zero_state(runtime)

    def state_leaves(self):
        return {k: (torch.float32, 1) for k in ("mom", "m", "v")}

    # ------------------------------------------------------------------ #
    @staticmethod
    def _orthogonalize(pl, mine: torch.Tensor) -> torch.Tensor:
        """``redistribute``'s per-matrix step: Newton-Schulz on this rank's
        whole matrices of one placement, scaled by ``sqrt(max(1, a/b))``."""
        a, b = pl.spec.shape
        return newton_schulz(mine).mul_(muon_scale(a, b))

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def update(self, runtime, params, grads, state, step: int,
               grad_scale=None):
        """In place on the masters, ``mom``, ``m`` and ``v``; ``grad_scale``
        as in ``SGDMomentum.update``."""
        if set(self._masks) != set(params):
            raise RuntimeError("Muon.update before Muon.init(runtime)")
        lr, c1, c2 = (float(x) for x in self.host_scalars(step))
        new_params = {}
        for name, pstate in params.items():
            lo = runtime.layouts[name]
            store = lo.store
            buf = store.trainable(pstate)
            g_all = grads[name]
            mom, m, v = (state[k][name] for k in ("mom", "m", "v"))
            use_muon = has_matrices(lo)
            # mom' = mu * mom + g on every group; the Nesterov input
            # mu * mom' + g of a preconditioned one
            nest = torch.empty(buf.shape, dtype=torch.float32,
                               device=buf.device) if use_muon else None
            for _, (mom_c, g_c, n_c) in pieces(mom, g_all, nest):
                g = grad_f32(g_c, grad_scale)
                mom_c.mul_(self.mu).add_(g)
                if n_c is not None:
                    torch.add(mom_c * self.mu, g, out=n_c)
            muon = (redistribute(runtime, lo, nest, self._orthogonalize)
                    if use_muon else None)
            del nest
            mask = self._masks[name]
            for (a, b), (w_c, g_c, m_c, v_c, u_c) in pieces(
                    buf, g_all, m, v, muon):
                upd = adam_direction(
                    grad_f32(g_c, grad_scale), m_c, v_c, b1=self.b1,
                    a1=1 - self.b1, b2=self.b2, a2=1 - self.b2,
                    eps=self.eps, c1=c1, c2=c2)
                mk = mask[a:b].float()
                if u_c is not None:
                    upd = mk * u_c + (1 - mk) * upd
                write_decayed(store, w_c, upd, mk, lr, self.wd)
                del upd, mk
            del muon
            new_params[name] = store.rebuild(pstate)
        return new_params, state
