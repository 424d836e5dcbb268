"""8-bit Adam (paper section 6.3) on flat DBuffer shards (port of
``repro/optim/adam8bit.py``): block-wise INT8-quantized moments.

Because the planner aligns every tensor start and the shard size to
``cfg.quant_block`` (the ``align`` option) for adam8bit models, quant
blocks over the rank-local shard never straddle a tensor start or a rank
boundary: each rank (de)quantizes its own shard with no communication.

State per group: ``m8``, ``v8`` (int8 codes, the group's local shape) and
``ms``, ``vs`` (one fp32 scale per quant block, ``(..., S / block)``);
``m`` is linear, ``v`` log-space (linear INT8 underflows v and explodes
the update).  The whole step -- moment decode, the Adam math, moment
requantize and the store's epilogue (bf16 round, fp8 encode, q8
requantize) -- is ONE fused launch per group
(``kernels.ops.adam8bit_store_update``: the hand-written CUDA kernel on the
card, its plain version on the CPU), in place on the parameter and state
buffers.  The weight-decay mask is one ``(S,)`` uint8 row per group,
shared by every layer row of a stacked group (``matrix_mask_local`` is the
same for each layer): a byte per element once, not an fp32 copy per layer.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .common import OptimizerBase, mask_rows, store_outputs


class Adam8bit(OptimizerBase):
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1

    def __init__(self, cfg):
        super().__init__(cfg)
        self.block = cfg.quant_block
        self._masks: dict[str, torch.Tensor] = {}

    def init(self, runtime):
        """Zero moment codes and scales, and this rank's decay-mask rows."""
        bq = self.block
        for lo in runtime.layouts.values():
            if lo.plan.shard_size % bq:
                raise ValueError(
                    f"group {lo.name}: shard {lo.plan.shard_size} not "
                    f"aligned to quant block {bq} -- planner align missing?")
        self._masks = mask_rows(runtime)
        return self.zero_state(runtime)

    def state_leaves(self):
        bq = self.block
        return {"m8": (torch.int8, 1), "v8": (torch.int8, 1),
                "ms": (torch.float32, bq), "vs": (torch.float32, bq)}

    @torch.no_grad()
    def update(self, runtime, params, grads, state, step: int,
               grad_scale=None):
        """One fused launch per group; ``grad_scale`` as in
        ``AdamW.update``."""
        if set(self._masks) != set(params):
            raise RuntimeError("Adam8bit.update before Adam8bit.init(runtime)")
        lr, c1, c2 = self.host_scalars(step)
        bq = self.block
        new_params = {}
        for name, pstate in params.items():
            store = runtime.layouts[name].store
            if store.quantized and store.block != bq:
                raise ValueError(
                    f"group {name}: store quant block {store.block} != "
                    f"optimizer quant block {bq}")
            buf = store.trainable(pstate)
            moments = tuple(state[k][name] for k in ("m8", "v8", "ms", "vs"))
            g = grads[name]
            core = ops.adam8bit_store_update(
                buf, g, *moments, self._masks[name], lr=lr,
                b1=self.b1, b2=self.b2, eps=self.eps, wd=self.wd, c1=c1,
                c2=c2, fmt=store.fmt, block=bq,
                out=store_outputs(store, pstate, buf) + moments,
                g_scale=grad_scale if g.dtype == torch.bfloat16 else None)[0]
            new_params[name] = store.wrap_core(core)
        return new_params, state
