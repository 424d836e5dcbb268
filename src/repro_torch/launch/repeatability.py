"""Whether a device's train step is bitwise repeatable.

    PYTHONPATH=src python -m repro_torch.launch.repeatability \\
        [--config gemma2-2b] [--device cuda|cpu] [--seeds 0,1,2,3] \\
        [--reps 3] [--processes 3] [--trace] [--busy N] [--alternate] \\
        [--card-first] [--unpinned]

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

The CPU is pinned as ``chip_smoke.py`` pins it (``pin_cpu``: MKL's
conditional numerical reproducibility and a fixed thread count, set before
torch loads); ``--unpinned`` runs the workers without it.  ``--trace``
records a digest of every operator's output, forward and backward (a
``TorchDispatchMode``), and prints per seed the distinct traces and, for
each trace other than the most common, the first operator whose output
differs from it: the op that starts a divergence.  ``--busy N`` keeps N
processes spinning on the host while the workers run (a loaded host);
``--alternate`` follows each CPU run with a card run in the same process;
``--card-first`` makes a card run before each process's first CPU run (the
order of ``chip_smoke.py``, whose CPU runs follow its card phases).  The
last line gives each seed's first stream too.
"""
from __future__ import annotations

import argparse
import collections
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys

# MKL's results depend on its code path and thread split unless
# conditional numerical reproducibility is on: STRICT pins the path for
# any alignment; a fixed count of threads and no dynamic adjustment pin the
# split.  Both are read once, when MKL loads with torch.
CPU_PIN = {"MKL_CBWR": "AUTO,STRICT", "MKL_DYNAMIC": "FALSE",
           "OMP_DYNAMIC": "FALSE"}
CPU_THREADS = 8


def pin_cpu(environ=os.environ) -> dict:
    """Set ``CPU_PIN`` (and ``MKL_NUM_THREADS`` / ``OMP_NUM_THREADS`` at
    ``CPU_THREADS``, or fewer on a smaller host) in ``environ`` where the
    caller has not set them; returns what is in force.  Call it before
    torch is imported: MKL reads them when it loads."""
    threads = str(min(CPU_THREADS, len(os.sched_getaffinity(0))))
    for k, v in {**CPU_PIN, "MKL_NUM_THREADS": threads,
                 "OMP_NUM_THREADS": threads}.items():
        environ.setdefault(k, v)
    return {k: environ[k] for k in (*CPU_PIN, "MKL_NUM_THREADS",
                                    "OMP_NUM_THREADS")}


STEPS, BATCH, SEQ = 2, 8, 64


def op_tracer():
    """A ``TorchDispatchMode`` whose ``ops`` list receives ``(op, digest
    of its tensor outputs' bytes, their shapes)`` for every operator run
    under it (no bytes for an ``empty*`` allocation or a collective)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class OpTrace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            h = hashlib.blake2b(digest_size=8)
            shapes = []
            # an allocation's bytes are whatever the memory held, and a
            # collective's output is written after it returns
            fresh = "empty" in str(func) or str(func).startswith("c10d.")
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and not fresh:
                    h.update(t.detach().contiguous().reshape(-1)
                             .view(torch.uint8).cpu().numpy().tobytes())
                    shapes.append(list(t.shape))
            self.ops.append((str(func), h.hexdigest(), shapes))
            return out

    return OpTrace()


def streams(config: str, device: str, seeds, reps: int,
            trace: bool = False, alternate: bool = False,
            card_first: bool = False) -> dict:
    """{seed: [run per rep]}, a run being ``{"stream": ((loss, grad_norm)
    per step)}`` and, with ``trace``, ``"trace"``: the op trace's digest
    and ``"ops"``: the trace itself for the first rep and for a rep whose
    trace differs from the first's.  ``alternate`` (with ``device`` cpu):
    each CPU run is followed by the same run on the card, untraced and
    unrecorded, as ``chip_smoke.py``'s ``parity`` phases alternate;
    ``card_first``: one such card run before the first CPU run."""
    import torch

    from ..configs import build_model, get_config
    from ..core.fsdp import FSDPRuntime
    from ..data.pipeline import DataConfig, SyntheticStream
    from ..optim import make_optimizer
    from .mesh import init_local_group

    torch.backends.cuda.matmul.allow_tf32 = False
    on_card = device == "cuda" or alternate or card_first
    group = init_local_group("cpu:gloo,cuda:nccl" if on_card else "gloo")
    model = get_config(config).reduced()
    out = {s: [] for s in seeds}
    first = {}

    def run_on(dev, seed, tracer=None):
        data = SyntheticStream(DataConfig(model.vocab, SEQ, BATCH,
                                          seed=seed), model)
        rt = FSDPRuntime(build_model(model), group,
                         compute_dtype=torch.float32, device=dev)
        params = rt.init_params(seed)
        opt = make_optimizer(model)
        state = opt.init(rt)
        step_fn = rt.make_train_step(opt)
        run, step = [], 0
        for i in range(STEPS):
            batch = data.shard(data.batch(i), rt)
            if tracer is None:
                params, state, step, m = step_fn(params, state, step, batch)
            else:
                with tracer:
                    params, state, step, m = step_fn(params, state, step,
                                                     batch)
            run.append((float(m["loss"]), float(m["grad_norm"])))
        return run

    if card_first:
        run_on("cuda", seeds[0])
    for _ in range(reps):
        for seed in seeds:
            tracer = op_tracer() if trace else None
            rec = {"stream": run_on(device, seed, tracer)}
            if alternate:
                run_on("cuda", seed)
            if tracer is not None:
                digest = hashlib.blake2b(json.dumps(tracer.ops).encode(),
                                         digest_size=8).hexdigest()
                rec["trace"] = digest
                if first.setdefault(seed, digest) != digest or \
                        len(out[seed]) == 0:
                    rec["ops"] = tracer.ops
            out[seed].append(rec)
    return out


def first_divergence(ops, base) -> dict:
    """Where trace ``ops`` first differs from trace ``base``: the index,
    both ops and the output shapes (the op whose output differs first)."""
    for i, (a, b) in enumerate(zip(ops, base)):
        if a != b:
            return {"index": i, "op": a[0], "base_op": b[0],
                    "shapes": a[2], "of": len(base)}
    return {"index": min(len(ops), len(base)), "op": None,
            "lengths": [len(ops), len(base)]}


def summary(runs: list) -> dict:
    first = runs[0]["stream"]
    distinct = {json.dumps(r["stream"]) for r in runs}
    worst = max(abs(a - b) / abs(b) for r in runs
                for sa, sb in zip(r["stream"], first)
                for a, b in zip(sa, sb))
    out = {"distinct": len(distinct), "max_rel_diff": worst}
    if "trace" in runs[0]:
        counts = collections.Counter(r["trace"] for r in runs)
        common = counts.most_common(1)[0][0]
        ops = {r["trace"]: r["ops"] for r in runs if "ops" in r}
        out["traces"] = dict(counts)
        out["divergences"] = {
            t: first_divergence(ops[t], ops[common])
            for t in counts if t != common and t in ops and common in ops}
    return out


def mkl_calls(stdout: str, runs: int) -> dict:
    """A worker's ``MKL_VERBOSE`` lines: the library's own header lines
    (version and code path) and its calls split into ``runs`` equal runs,
    each call with its pointers and time taken out (its routine, sizes,
    CNR mode, dynamic flag and thread count are left)."""
    import re

    head, calls = [], []
    for line in stdout.splitlines():
        if not line.startswith("MKL_VERBOSE"):
            continue
        if "(" not in line.split()[1]:
            head.append(line)
            continue
        line = re.sub(r"0x[0-9a-f]+", "p", line)
        calls.append(re.sub(r" [0-9.]+[mun]?s ", " ", line))
    n = len(calls) // runs if runs and len(calls) % runs == 0 else 0
    return {"header": sorted(set(head)),
            "runs": [calls[i * n:(i + 1) * n] for i in range(runs)]
            if n else [calls]}


def _spin(stop) -> None:
    while not stop.is_set():
        pass


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="gemma2-2b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--trace", action="store_true",
                    help="record every operator's output digest and name "
                         "the first op of a divergence")
    ap.add_argument("--busy", type=int, default=0,
                    help="processes kept spinning while the workers run")
    ap.add_argument("--alternate", action="store_true",
                    help="with --device cpu: a card run after each CPU "
                         "run, as chip_smoke.py's parity phases")
    ap.add_argument("--card-first", action="store_true",
                    help="a card run before each process's first CPU run")
    ap.add_argument("--mkl-verbose", action="store_true",
                    help="run the workers with MKL_VERBOSE=1 and compare "
                         "each run's MKL calls (thread counts, code path) "
                         "with the first run's")
    ap.add_argument("--unpinned", action="store_true",
                    help="run the workers without pin_cpu's settings")
    ap.add_argument("--worker", action="store_true",
                    help="run in this process and print its streams")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    env = os.environ.copy()
    pinned = None if args.unpinned else pin_cpu(env)
    if args.worker:
        print(json.dumps(streams(args.config, args.device, seeds,
                                 args.reps, args.trace, args.alternate,
                                 args.card_first)))
        return
    import torch

    if (args.device == "cuda" or args.alternate or args.card_first) \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "repeatability runs on the card by default and no CUDA device "
            "is available; pass --device cpu")
    ctx = multiprocessing.get_context("spawn")
    stop = ctx.Event()
    spinners = [ctx.Process(target=_spin, args=(stop,), daemon=True)
                for _ in range(args.busy)]
    for p in spinners:
        p.start()
    every = {s: [] for s in seeds}
    if args.mkl_verbose:
        env["MKL_VERBOSE"] = "1"
    base_calls, mkl = None, {"headers": set(), "runs": 0,
                             "differing_runs": [], "threads": {}}
    try:
        for p in range(args.processes):
            cmd = [sys.executable, "-m", "repro_torch.launch.repeatability",
                   "--worker", "--config", args.config, "--device",
                   args.device, "--seeds", args.seeds, "--reps",
                   str(args.reps)]
            cmd += (["--trace"] * args.trace + ["--unpinned"] * args.unpinned
                    + ["--alternate"] * args.alternate
                    + ["--card-first"] * args.card_first)
            done = subprocess.run(cmd, capture_output=True, text=True,
                                  env=env)
            if done.returncode:
                raise SystemExit(
                    f"worker {p} failed:\n{done.stderr[-3000:]}")
            got = json.loads(next(
                line for line in reversed(done.stdout.splitlines())
                if line.startswith("{")))
            if args.mkl_verbose:
                mc = mkl_calls(done.stdout, args.reps * len(seeds))
                mkl["headers"].update(mc["header"])
                for r, calls in enumerate(mc["runs"]):
                    mkl["runs"] += 1
                    for c in calls:
                        t = c.rsplit("NThr:", 1)[-1].strip()
                        mkl["threads"][t] = mkl["threads"].get(t, 0) + 1
                    if base_calls is None:
                        base_calls = calls
                    elif calls != base_calls:
                        diff = [i for i, (a, b) in enumerate(
                            zip(calls, base_calls)) if a != b]
                        mkl["differing_runs"].append({
                            "process": p, "run": r, "calls": len(calls),
                            "of": len(base_calls), "differ": len(diff),
                            "first": [calls[diff[0]], base_calls[diff[0]]]
                            if diff else None})
            per_seed = {int(s): r for s, r in got.items()}
            print(json.dumps({"process": p, **{str(s): summary(r)
                                               for s, r in per_seed.items()}
                              }), flush=True)
            for s, r in per_seed.items():
                every[s] += r
    finally:
        stop.set()
        for p in spinners:
            p.join()
    print(json.dumps({"config": args.config, "device": args.device,
                      "pinned": pinned, "busy": args.busy,
                      "alternate": args.alternate,
                      "card_first": args.card_first,
                      "first_streams": {str(s): r[0]["stream"]
                                        for s, r in every.items()},
                      "host_cpus": len(os.sched_getaffinity(0)),
                      "runs_per_seed": args.processes * args.reps,
                      **({"mkl": {**mkl, "headers": sorted(mkl["headers"])}}
                         if args.mkl_verbose else {}),
                      **{str(s): summary(r) for s, r in every.items()}}))


if __name__ == "__main__":
    main()
