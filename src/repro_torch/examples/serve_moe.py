"""Batched MoE serving example: prefill + decode with ZeRO-3 parameter
gathering and top-k expert routing (port of ``examples/serve_moe.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_moe [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ._common import COMPUTE_DTYPES, local_mesh, parser


def main(argv=None) -> list[list[int]]:
    """Prints the reference's lines; returns each request's greedy
    tokens."""
    args = parser(__doc__).parse_args(argv)
    cfg = get_config("granite-moe-1b-a400m").reduced()
    with local_mesh(args.device) as mesh:
        model = build_model(cfg)
        rt = FSDPRuntime(model, mesh, device=args.device,
                         compute_dtype=COMPUTE_DTYPES[args.compute_dtype])
        params = rt.init_params(0)
        prefill = rt.make_prefill_step()
        decode = rt.make_decode_step()

        B, P, GEN = 4, 24, 12
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (B, P))).to(rt.device)}
        cache = rt.init_cache(B, P + GEN)

        t0 = time.time()
        logits, cache = prefill(params, batch, cache)
        nxt = torch.argmax(logits[:, -1], -1)
        print(f"prefill {B} prompts x {P} tokens "
              f"({cfg.n_experts} experts, top-{cfg.top_k}) in "
              f"{time.time()-t0:.2f}s")

        seqs = [nxt.cpu()]
        for i in range(GEN - 1):
            db = {"tokens": nxt[:, None]}
            logits, cache = decode(params, db, cache, P + i)
            nxt = torch.argmax(logits[:, -1], -1)
            seqs.append(nxt.cpu())
        gen = torch.stack(seqs, 1).tolist()
    for b in range(B):
        print(f"request[{b}] -> {gen[b]}")
    return gen


if __name__ == "__main__":
    main()
