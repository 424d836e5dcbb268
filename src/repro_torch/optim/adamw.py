"""AdamW on flat DBuffer shards (port of ``repro/optim/adamw.py``).

The whole per-group step -- moment update and weight write in the store's
format -- is ONE fused kernel through the dispatch layer
(``kernels.ops.adamw_store_update``: the hand-written CUDA kernel on the
card, its plain PyTorch version on the CPU).  The update runs in place on
the parameter and moment buffers; for an fp8 or q8_block store the same
launch rewrites the state's codes (and q8 scales) from the updated master,
and a bf16 store's bf16 buffer and gradient go in as they are.  ``lr``, ``c1`` and ``c2`` are float32
scalars computed on the host from the Python step counter, so the loop
never waits on the device for them.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import OptimizerBase, mask_row, store_outputs


class AdamW(OptimizerBase):
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1

    def __init__(self, cfg):
        super().__init__(cfg)
        self._masks: dict[str, torch.Tensor] = {}

    def init(self, runtime):
        """Zero moments, and the weight-decay masks of this rank (one fp32
        buffer per group, shaped like the group's local shard)."""
        self._masks = {
            name: mask_row(runtime, lo, torch.float32)
            .expand(lo.local_shape()).contiguous()
            for name, lo in runtime.layouts.items()}
        return self.zero_state(runtime)

    def state_leaves(self):
        return {"m": (torch.float32, 1), "v": (torch.float32, 1)}

    @torch.no_grad()
    def update(self, runtime, params, grads, state, step: int,
               grad_scale=None):
        """One fused launch per group.  ``grad_scale`` (a 0-d fp32 tensor
        or None): the scale the bf16 gradients still need (the train step
        scales fp32 gradients in place), applied in fp32 by the kernel."""
        if set(self._masks) != set(params):
            raise RuntimeError("AdamW.update before AdamW.init(runtime)")
        lr, c1, c2 = self.host_scalars(step)
        new_params = {}
        for name, pstate in params.items():
            store = runtime.layouts[name].store
            buf = store.trainable(pstate)
            m, v = state["m"][name], state["v"][name]
            g = grads[name]
            core, _, _ = ops.adamw_store_update(
                buf, g, m, v, self._masks[name], lr=lr, b1=self.b1,
                b2=self.b2, eps=self.eps, wd=self.wd, c1=c1, c2=c2,
                fmt=store.fmt, block=store.block,
                out=store_outputs(store, pstate, buf) + (m, v),
                g_scale=grad_scale if g.dtype == torch.bfloat16 else None)
            new_params[name] = store.wrap_core(core)
        return new_params, state
