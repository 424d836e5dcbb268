"""Continuous-batching serving: requests of different lengths stream
through a fixed slot pool; finished requests retire and queued ones are
admitted without stalling the batch (port of
``examples/continuous_batching.py``).

    PYTHONPATH=src python -m repro_torch.examples.continuous_batching \
        [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..serve.engine import Request, ServeEngine
from ._common import COMPUTE_DTYPES, local_mesh, parser


def main(argv=None) -> dict[int, list[int]]:
    """Prints the reference's lines; returns each request's tokens by
    uid."""
    args = parser(__doc__).parse_args(argv)
    cfg = get_config("qwen2.5-14b").reduced()
    with local_mesh(args.device) as mesh:
        model = build_model(cfg)
        rt = FSDPRuntime(model, mesh, device=args.device,
                         compute_dtype=COMPUTE_DTYPES[args.compute_dtype])
        params = rt.init_params(0)

        eng = ServeEngine(rt, model, params, pool=3, max_len=96)
        rng = np.random.default_rng(0)
        n_req = 7
        for i in range(n_req):
            eng.submit(Request(
                uid=i,
                prompt=rng.integers(0, cfg.vocab, (4 + 3 * i,)).astype(
                    np.int32),
                max_new=6 + (i % 3),
            ))

        t0 = time.time()
        steps = 0
        while eng.queue or any(s.req for s in eng.slots):
            n = eng.step()
            steps += 1
            if steps % 10 == 0:
                done = len(eng.finished)
                print(f"step {steps:3d}: {n} active rows, {done}/{n_req} "
                      f"done")
        dt = time.time() - t0
    print(f"\nserved {n_req} requests in {steps} engine steps ({dt:.1f}s)")
    for r in sorted(eng.finished, key=lambda r: r.uid):
        print(f"  req[{r.uid}] prompt_len={len(r.prompt):2d} -> {r.out}")
    return {r.uid: list(r.out) for r in eng.finished}


if __name__ == "__main__":
    main()
