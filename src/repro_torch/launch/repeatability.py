"""Whether a device's train step is bitwise repeatable.

    PYTHONPATH=src python -m repro_torch.launch.repeatability \\
        [--config gemma2-2b] [--device cuda|cpu] [--seeds 0,1,2,3] \\
        [--reps 3] [--processes 3]

    PYTHONPATH=src python -m repro_torch.launch.repeatability --device cpu

Runs the set-up of ``chip_smoke.py``'s ``parity`` phases -- the config's
``reduced()`` model, fp32 compute, two train steps from
``init_params(seed)`` on a ``SyntheticStream`` of 8 x 64 tokens -- ``reps``
times per seed in each of ``processes`` fresh processes (one rank).
Prints one JSON line per process and a last line with, per seed, the
number of distinct (loss, grad norm) streams over all runs and the largest
relative difference of a stream from the first.  A repeatable device
prints 1 and 0.0 for every seed.  It runs on the card unless given
``--device cpu`` (the CPU check), and raises where no card is present.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..data.pipeline import DataConfig, SyntheticStream
from ..optim import make_optimizer
from .mesh import init_local_group

STEPS, BATCH, SEQ = 2, 8, 64


def streams(config: str, device: str, seeds, reps: int) -> dict:
    """{seed: [stream per rep]}, a stream being ((loss, grad_norm) per
    step)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    group = init_local_group("gloo" if device == "cpu"
                             else "cpu:gloo,cuda:nccl")
    model = get_config(config).reduced()
    out = {s: [] for s in seeds}
    for _ in range(reps):
        for seed in seeds:
            data = SyntheticStream(DataConfig(model.vocab, SEQ, BATCH,
                                              seed=seed), model)
            rt = FSDPRuntime(build_model(model), group,
                             compute_dtype=torch.float32, device=device)
            params = rt.init_params(seed)
            opt = make_optimizer(model)
            state = opt.init(rt)
            step_fn = rt.make_train_step(opt)
            run, step = [], 0
            for i in range(STEPS):
                params, state, step, m = step_fn(
                    params, state, step, data.shard(data.batch(i), rt))
                run.append((float(m["loss"]), float(m["grad_norm"])))
            out[seed].append(run)
    return out


def summary(runs: list) -> dict:
    first = runs[0]
    distinct = {json.dumps(r) for r in runs}
    worst = max(abs(a - b) / abs(b) for r in runs
                for sa, sb in zip(r, first) for a, b in zip(sa, sb))
    return {"distinct": len(distinct), "max_rel_diff": worst}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="gemma2-2b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--worker", action="store_true",
                    help="run in this process and print its streams")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repeatability runs on the card by default and no CUDA device "
            "is available; pass --device cpu")
    if args.worker:
        print(json.dumps(streams(args.config, args.device, seeds,
                                 args.reps)))
        return
    every = {s: [] for s in seeds}
    for p in range(args.processes):
        cmd = [sys.executable, "-m", "repro_torch.launch.repeatability",
               "--worker", "--config", args.config, "--device", args.device,
               "--seeds", args.seeds, "--reps", str(args.reps)]
        done = subprocess.run(cmd, capture_output=True, text=True,
                              env=os.environ.copy())
        if done.returncode:
            raise SystemExit(f"worker {p} failed:\n{done.stderr[-3000:]}")
        got = json.loads(done.stdout.strip().splitlines()[-1])
        per_seed = {int(s): r for s, r in got.items()}
        print(json.dumps({"process": p, **{str(s): summary(r)
                                           for s, r in per_seed.items()}}))
        for s, r in per_seed.items():
            every[s] += r
    print(json.dumps({"config": args.config, "device": args.device,
                      "threads": torch.get_num_threads(),
                      "runs_per_seed": args.processes * args.reps,
                      **{str(s): summary(r) for s, r in every.items()}}))


if __name__ == "__main__":
    main()
