"""Distributed Shampoo via layer-axis redistribution (port of
``repro/optim/shampoo.py``; paper section 2.1).

Shampoo preconditions each 2-D parameter with Kronecker factors ``L = sum
G G^T`` and ``R = sum G^T G``: ``update = L^{-1/4} G R^{-1/4}``.  Like Muon
it needs whole matrices, and it uses the same redistribution: the gradient
``(L, S)`` is all-gathered along the shard axis, L is padded to ``Lp =
ceil(L / m) * m`` and each rank takes its ``Lp / m`` whole matrices.  The
factors ``{group}/{tensor}/L|R`` are stored sharded the same way -- each
rank keeps only its ``Lp / m`` rows of the ``(Lp, k, k)`` factor -- so the
factor update is local, and only the preconditioned update is gathered
back.  The gathers run over the group's FSDP axes, and a matrix split
over the model axis is assembled whole first (``common.redistribute``):
its factors are the whole matrix's, replicated over the model axis as
over a pod axis, so a tensor-parallel run keeps the one-device factors and
checkpoints the files of tp 1.  The preconditioned update is grafted to
the gradient's per-matrix RMS.  The inverse 4th roots take an
eigendecomposition every step, as the reference does (production systems
amortize it over ~100 steps).

Non-2-D parameters and unstacked groups take the Adam fallback, whose
literals (0.9, 0.1, 0.95, 0.05, 1e-8) are the reference's as written.  The
elementwise chain runs over column chunks (``common.pieces``).

PARITY: ALLCLOSE.  ``torch.linalg.eigh`` (LAPACK on the CPU, cuSOLVER on
the card) returns another basis than XLA's eigensolver wherever eigenvalues
are close, and ``V w^{-1/4} V^T`` is the same matrix only up to the
solver's accuracy; the factor products and the graft's sums run in
another order (tests/test_torch_optim.py states the bounds).
"""
from __future__ import annotations

import torch

from .common import (OptimizerBase, adam_direction, fsdp_world, grad_f32,
                     has_matrices, mask_rows, pieces, redistribute,
                     whole_shape, write_decayed)


def _inv_4th_root(M: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """M symmetric PSD, (k, k) or a batch (l, k, k) -> M^{-1/4} by an fp32
    eigendecomposition, eigenvalues clamped at ``eps * max(w_max, 1)``."""
    w, V = torch.linalg.eigh(M.float())
    floor = eps * torch.clamp(w.amax(dim=-1, keepdim=True), min=1.0)
    w = torch.maximum(w, floor)
    return (V * w.pow(-0.25).unsqueeze(-2)) @ V.mT


def factor_keys(group: str, tensor: str) -> tuple[str, str]:
    """The state keys of one tensor's left and right factors."""
    return f"{group}/{tensor}/L", f"{group}/{tensor}/R"


class Shampoo(OptimizerBase):
    b1 = 0.9          # momentum on the preconditioned update; with b2,
    b2 = 0.95         # the bias corrections' bases (``host_scalars``)
    eps, wd = 1e-6, 0.1

    def __init__(self, cfg):
        super().__init__(cfg)
        self._masks: dict[str, torch.Tensor] = {}

    def init(self, runtime):
        """Zero ``mom``, ``m``, ``v`` and factors, and this rank's mask
        rows."""
        self._masks = mask_rows(runtime)
        return self.zero_state(runtime)

    def state_leaves(self):
        return {k: (torch.float32, 1) for k in ("mom", "m", "v")}

    def extra_leaves(self, runtime):
        """The Kronecker factors, ``(Lp, a, a)`` and ``(Lp, b, b)`` per 2-D
        tensor of a stacked group at its whole shape (a tensor split over
        the model axis included), sharded over the padded layer axis across
        the group's FSDP axes and replicated over the others (whole on
        every rank for an unsharded group)."""
        facs = {}
        for gname, lo in runtime.layouts.items():
            if lo.n_layers is None:
                continue
            m = fsdp_world(lo)
            lp = -(-lo.n_layers // m) * m
            for pl in lo.plan.placements:
                if len(pl.spec.shape) != 2:
                    continue
                a, b = whole_shape(lo, pl)
                kl, kr = factor_keys(gname, pl.spec.name)
                axis = 0 if lo.fsdp_axes else None
                facs[kl] = (torch.float32, (lp, a, a), axis)
                facs[kr] = (torch.float32, (lp, b, b), axis)
        return {"factors": facs}

    # ------------------------------------------------------------------ #
    def _precondition_group(self, runtime, lo, gname, g: torch.Tensor,
                            factors) -> torch.Tensor:
        """``g``: this rank's ``(L, S)`` fp32 gradient.  Updates this rank's
        factor rows in place; returns the ``(L, S)`` preconditioned update
        of the 2-D positions (zeros elsewhere)."""
        def precondition(name, mine):
            kl, kr = factor_keys(gname, name)
            Lf = factors[kl].add_(mine @ mine.mT)
            Rf = factors[kr].add_(mine.mT @ mine)
            o = (_inv_4th_root(Lf) @ mine) @ _inv_4th_root(Rf)
            # graft to the gradient's per-matrix RMS (keeps lr comparable)
            gn = torch.sqrt(torch.mean(mine.square(), dim=(1, 2),
                                       keepdim=True))
            on = torch.sqrt(torch.mean(o.square(), dim=(1, 2), keepdim=True))
            return o * (gn / torch.clamp(on, min=1e-12))

        return redistribute(runtime, lo, g, precondition)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def update(self, runtime, params, grads, state, step: int,
               grad_scale=None):
        """In place on the masters, ``mom``, ``m``, ``v`` and this rank's
        factor rows; ``grad_scale`` as in ``SGDMomentum.update``."""
        if set(self._masks) != set(params):
            raise RuntimeError("Shampoo.update before Shampoo.init(runtime)")
        lr, c1, c2 = (float(x) for x in self.host_scalars(step))
        new_params = {}
        for name, pstate in params.items():
            lo = runtime.layouts[name]
            store = lo.store
            buf = store.trainable(pstate)
            g_all = grads[name]
            mom, m, v = (state[k][name] for k in ("mom", "m", "v"))
            pre = None
            if has_matrices(lo):
                pre = self._precondition_group(
                    runtime, lo, name, grad_f32(g_all, grad_scale),
                    state["factors"])
            mask = self._masks[name]
            for (a, b), (w_c, g_c, m_c, v_c, mom_c, p_c) in pieces(
                    buf, g_all, m, v, mom, pre):
                upd = adam_direction(
                    grad_f32(g_c, grad_scale), m_c, v_c, b1=0.9, a1=0.1,
                    b2=0.95, a2=0.05, eps=1e-8, c1=c1, c2=c2)
                mk = mask[a:b].float()
                if p_c is not None:
                    mom_c.mul_(self.b1).add_(p_c)
                    upd = mk * mom_c + (1 - mk) * upd
                write_decayed(store, w_c, upd, mk, lr, self.wd)
                del upd, mk
            del pre
            new_params[name] = store.rebuild(pstate)
        return new_params, state
