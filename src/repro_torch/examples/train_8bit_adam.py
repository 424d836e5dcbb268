"""Figure 10(a) reproduction: 8-bit Adam (block-wise quantized moments)
loss curve vs fp32 AdamW on the same model/data (port of
``examples/train_8bit_adam.py``).

RaggedShard makes this communication-free: the planner aligns every tensor
start and the shard size to the quant block, so each rank quantizes its
local shard independently (no metadata exchange -- the paper's point).

    PYTHONPATH=src python -m repro_torch.examples.train_8bit_adam \
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


def run(optname: str, steps: int = STEPS, device: str = "cuda",
        compute_dtype: str = "bfloat16") -> list[float]:
    """The loss stream of ``steps`` steps of gpt-oss-120b.reduced() (quant
    block 64, lr 1e-3) under optimizer ``optname``."""
    cfg = dataclasses.replace(
        get_config("gpt-oss-120b").reduced(), optimizer=optname,
        quant_block=64, learning_rate=1e-3)
    with local_mesh(device) as mesh:
        model = build_model(cfg)
        rt = FSDPRuntime(model, mesh, device=device,
                         compute_dtype=COMPUTE_DTYPES[compute_dtype])
        params = rt.init_params(0)
        opt = make_optimizer(cfg)
        state = opt.init(rt)
        fn = rt.make_train_step(opt)
        stream = SyntheticStream(DataConfig(cfg.vocab, 64, 8, seed=1), cfg)
        step = 0
        losses = []
        for i in range(steps):
            b = stream.shard(stream.batch(i), rt)
            params, state, step, m = fn(params, state, step, b)
            losses.append(float(m["loss"]))
    return losses


def main(argv=None) -> dict:
    """Prints the reference's table and gap; returns both loss streams."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    l32 = run("adamw", args.steps, args.device,
              args.compute_dtype)
    l8 = run("adam8bit", args.steps, args.device,
              args.compute_dtype)
    print(f"{'step':>5s} {'adamw':>8s} {'adam8bit':>9s}")
    for i in range(0, args.steps, 10):
        print(f"{i:5d} {l32[i]:8.4f} {l8[i]:9.4f}")
    print(f"final {l32[-1]:8.4f} {l8[-1]:9.4f}")
    gap = abs(l8[-1] - l32[-1])
    print(f"\nfinal-loss gap = {gap:.3f} "
          f"(paper Fig.10a: curves track closely; occasional spikes are "
          f"characteristic of reduced-precision states)")
    if not gap < 0.3:
        raise RuntimeError("8-bit Adam diverged from fp32 AdamW")
    return {"adamw": l32, "adam8bit": l8}


if __name__ == "__main__":
    main()
