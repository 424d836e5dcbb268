"""SGD with momentum on flat shards (port of ``repro/optim/sgd.py``; the
paper's OOM-avoidance baseline for GPT-OSS).

State ``m`` only, shaped like each group's buffer.  The update is PyTorch
tensor code over column chunks of the shard (``common.pieces``), in the
reference's order: ``m' = mu * m + g``, ``w' = w - lr * m'``, then the
store's ``rebuild``.  PARITY: ALLCLOSE -- the same roundings, but XLA:CPU
may contract a product and a sum into one FMA where the port rounds both
(tests/test_torch_optim.py states the bound).
"""
from __future__ import annotations

import torch

from .common import OptimizerBase, grad_f32, pieces


class SGDMomentum(OptimizerBase):
    mu = 0.9

    def init(self, runtime):
        return self.zero_state(runtime)

    def state_leaves(self):
        return {"m": (torch.float32, 1)}

    @torch.no_grad()
    def update(self, runtime, params, grads, state, step: int,
               grad_scale=None):
        """In place on the masters and ``m``; ``grad_scale`` (a 0-d fp32
        tensor or None): the scale a bf16 gradient still needs
        (``common.grad_f32``)."""
        lr = float(self.schedule(step))
        new_params = {}
        for name, pstate in params.items():
            store = runtime.layouts[name].store
            buf = store.trainable(pstate)
            for _, (w_c, g_c, m_c) in pieces(buf, grads[name],
                                             state["m"][name]):
                m_c.mul_(self.mu).add_(grad_f32(g_c, grad_scale))
                w = store.master_f32(w_c)
                w.sub_(lr * m_c)
                if w is not w_c:
                    w_c.copy_(w)
            new_params[name] = store.rebuild(pstate)
        return new_params, state
