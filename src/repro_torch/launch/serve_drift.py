"""How far the int8 serve mode's logits drift from the dense q8 serve's,
by depth.

    PYTHONPATH=src python -m repro_torch.launch.serve_drift

gemma2-2b at published width with 1, 2 and 4 layers on the q8_block store
(one set of parameters per depth, seed 0), one NCCL rank: the prefill
logits of 4 x 512 seeded prompt tokens in the int8 mode
(``serve_quant_matmul``) and the dense-dequant q8 mode, each at fp32 and
bf16 compute.  Prints one JSON line per depth: each run's relative L2
against the fp32 dense run (whose weights are the stored codes times their
scales exactly), the int8-vs-dense gap at bf16, and the logits' standard
deviation.  Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..core.schedule import CommSchedule
from .mesh import init_local_group

DEPTHS = (1, 2, 4)
BATCH, PROMPT, CACHE = 4, 512, 1024
MODES = {"int8": {"param_store": "q8_block", "serve_quant_matmul": True},
         "dense": {"param_store": "q8_block"}}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("serve_drift needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    group = init_local_group("nccl")
    full = get_config("gemma2-2b")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, full.vocab, (BATCH, PROMPT))).cuda()
    for layers in DEPTHS:
        model = build_model(dataclasses.replace(full, n_layers=layers))
        out, params = {}, None
        for dtype in (torch.float32, torch.bfloat16):
            for mode, sched in MODES.items():
                rt = FSDPRuntime(model, group, compute_dtype=dtype,
                                 schedule=CommSchedule(**sched))
                if params is None:
                    params = rt.init_params(0)
                cache = rt.init_cache(BATCH, CACHE)
                logits, _ = rt.make_prefill_step()(
                    params, {"tokens": prompts}, cache)
                out[(mode, str(dtype)[6:])] = logits.float()
        truth = out[("dense", "float32")]
        print(json.dumps({
            "layers": layers,
            "device": torch.cuda.get_device_name(0),
            **{f"{m}_{d}_vs_dense_f32": rel_l2(v, truth)
               for (m, d), v in out.items()},
            "int8_vs_dense_bf16": rel_l2(out[("int8", "bfloat16")],
                                         out[("dense", "bfloat16")]),
            "logit_std": float(truth.std())}), flush=True)
        del params, model, out
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
