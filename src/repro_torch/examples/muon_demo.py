"""Figure 10(b) reproduction: distributed Muon vs AdamW loss curves (port
of ``examples/muon_demo.py``).

Muon's Newton-Schulz step needs whole 2-D matrices; RaggedShard's
redistribute (layer-resharding across the FSDP group) gives each rank a
load-balanced set of full matrices to precondition.

    PYTHONPATH=src python -m repro_torch.examples.muon_demo \
        [--device cpu] [--steps 120]
"""
from __future__ import annotations

import dataclasses

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..data.pipeline import DataConfig, SyntheticStream
from ..optim import make_optimizer
from ._common import COMPUTE_DTYPES, local_mesh, parser

STEPS = 120


def run(optname: str, lr: float, steps: int = STEPS, device: str = "cuda",
        compute_dtype: str = "bfloat16") -> list[float]:
    """The loss stream of ``steps`` steps of qwen2.5-14b.reduced() at
    learning rate ``lr`` under optimizer ``optname``."""
    cfg = dataclasses.replace(
        get_config("qwen2.5-14b").reduced(), optimizer=optname,
        learning_rate=lr)
    with local_mesh(device) as mesh:
        model = build_model(cfg)
        rt = FSDPRuntime(model, mesh, device=device,
                         compute_dtype=COMPUTE_DTYPES[compute_dtype])
        params = rt.init_params(0)
        opt = make_optimizer(cfg)
        state = opt.init(rt)
        fn = rt.make_train_step(opt)
        stream = SyntheticStream(DataConfig(cfg.vocab, 64, 8, seed=2), cfg)
        step = 0
        losses = []
        for i in range(steps):
            b = stream.shard(stream.batch(i), rt)
            params, state, step, m = fn(params, state, step, b)
            losses.append(float(m["loss"]))
    return losses


def main(argv=None) -> dict:
    """Prints the reference's table; asserts its check; returns both loss
    streams."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    adamw = run("adamw", 1e-3, args.steps, args.device,
              args.compute_dtype)
    muon = run("muon", 3e-3, args.steps, args.device,
              args.compute_dtype)
    print(f"{'step':>5s} {'adamw':>8s} {'muon':>8s}")
    for i in range(0, args.steps, 10):
        print(f"{i:5d} {adamw[i]:8.4f} {muon[i]:8.4f}")
    print(f"final {adamw[-1]:8.4f} {muon[-1]:8.4f}")
    print("\npaper Fig.10b: Muon converges faster, stabilizing ~0.01 lower. "
          "At this 2-layer/256-d smoke scale the advantage is within noise; "
          "we check Muon trains comparably (gap < 0.25) -- the distributed "
          "redistribute machinery itself is verified across ranks in "
          "tests/test_torch_optim.py and tests/test_torch_tp_optim.py")
    if not muon[-1] <= adamw[-1] + 0.25:
        raise RuntimeError((muon[-1], adamw[-1]))
    return {"adamw": adamw, "muon": muon}


if __name__ == "__main__":
    main()
