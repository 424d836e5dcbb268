"""Quickstart: shard a model with veScale-FSDP-style RaggedShard planning
and train it for a few steps on synthetic data (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..data.pipeline import DataConfig, SyntheticStream
from ..optim import make_optimizer
from ._common import COMPUTE_DTYPES, local_mesh, parser


def main(argv=None) -> dict:
    """Prints the reference's lines; returns every step's ``loss`` and
    ``grad_norm``."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    # 1. pick an architecture and reduce it to CPU scale; the full config
    #    is identical code at mesh scale.
    cfg = get_config("gemma2-2b").reduced()

    # 2. build the model and wrap it for the mesh -- this runs the paper's
    #    planner (Algorithm 1) per communication group and backs every
    #    group with a flat DBuffer sharded over the FSDP axes.
    out = {"loss": [], "grad_norm": []}
    with local_mesh(args.device) as mesh:
        model = build_model(cfg)
        runtime = FSDPRuntime(model, mesh, device=args.device,
                         compute_dtype=COMPUTE_DTYPES[args.compute_dtype])
        for name, lo in runtime.layouts.items():
            print(f"group {name:12s} shard={lo.plan.shard_size:>10,} elems  "
                  f"padding={lo.plan.padding_ratio:.4%}  "
                  f"tensors={len(lo.plan.placements)}")

        # 3. init + train
        params = runtime.init_params(seed=0)
        optimizer = make_optimizer(cfg)
        opt_state = optimizer.init(runtime)
        train_step = runtime.make_train_step(optimizer)

        stream = SyntheticStream(DataConfig(cfg.vocab, 64, 8), cfg)
        step = 0
        for i in range(args.steps):
            batch = stream.shard(stream.batch(i), runtime)
            params, opt_state, step, m = train_step(params, opt_state, step,
                                                    batch)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            if i % 5 == 0 or i == args.steps - 1:
                print(f"step {i:3d}  loss {out['loss'][-1]:.4f}  "
                      f"grad_norm {out['grad_norm'][-1]:.3f}")
    return out


if __name__ == "__main__":
    main()
