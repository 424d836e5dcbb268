"""Where the device time of one ZeRO-3 step (train or decode) goes.

    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        [--config gemma2|qwen3-moe|qwen2.5-muon] \
        [--store fp32|bf16|fp8_e4m3|fp8_e5m2|q8_block | --q8 | --serve]

Builds a configuration ``chip_smoke.py`` trains -- ``gemma2`` (default):
gemma2-2b at published width, depth cut to 4 layers, batch 2 x 2048, AdamW;
``qwen3-moe``: qwen3-moe-235b-a22b at published width, depth cut to 1
layer, ep=1, batch 1 x 2048, Adam8bit; ``qwen2.5-muon``: qwen2.5-14b at
published width, depth cut to 2 layers, batch 1 x 2048, Muon
(``train_muon_q8`` runs it with ``--store q8_block``) -- with bf16 compute
and the
``--store`` parameter store (fp32 by default; or, with ``--q8``, the
q8_block store and the q8 gradient wire with error feedback on every
group), runs two warm-up steps on one rank of a NCCL group, then one step
under ``torch.profiler``.  ``--serve`` profiles
a decode step instead: the config on the q8_block store with
``serve_quant_matmul`` (``chip_smoke.py``'s ``serve`` phase: a prefill of
4 x 512 tokens into a 1024-slot cache, two warm-up decode steps at batch
4).  It prints JSON lines:
the step's wall time, the summed device time of its kernels by category
(matmul, optimizer kernel, q8 codec kernels, collective, other) and the device's idle share
of the step, then the kernels with the most device time.  Needs a CUDA
card; it does not run on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from ..configs import build_model, get_config
from ..core.fsdp import FSDPRuntime
from ..core.schedule import CommSchedule
from ..data.pipeline import DataConfig, SyntheticStream
from ..optim import make_optimizer
from .mesh import init_local_group

# kernel-name fragments -> category (cuBLAS/CUTLASS GEMM names, NCCL, ours)
CATEGORIES = (
    ("q8 matmul", ("q8mm_",)),
    ("optimizer", ("adamw_flat", "adamw_q8", "adam8_store", "adam8_flat")),
    ("q8 codec", ("quantize_kernel", "dequantize_kernel", "encode_ef_kernel")),
    ("collective", ("nccl",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


# config -> (arch id, layers, batch, sequence length, optimizer or None
# for the config's own)
CONFIGS = {"gemma2": ("gemma2-2b", 4, 2, 2048, None),
           "qwen3-moe": ("qwen3-moe-235b-a22b", 1, 1, 2048, None),
           "qwen2.5-muon": ("qwen2.5-14b", 2, 1, 2048, "muon")}
WARMUP, TOP = 2, 15
# the serve mode's batch, prompt length and cache length
SERVE_BATCH, SERVE_PROMPT, SERVE_LEN = 4, 512, 1024


def train_step(cfg, args):
    """Warm a train step up; returns a closure running one more step (and
    its loss) and the schedule's name."""
    sched = CommSchedule(param_store="q8_block", reduce_wire="q8_block") \
        if args.q8 else CommSchedule(param_store=args.store)
    rt = FSDPRuntime(build_model(cfg), init_local_group("nccl"),
                     compute_dtype=torch.bfloat16, schedule=sched)
    params = rt.init_params(0)
    opt = make_optimizer(cfg)
    opt_state = opt.init(rt)
    step_fn = rt.make_train_step(opt)
    _, _, batch_size, seq, _ = CONFIGS[args.config]
    stream = SyntheticStream(DataConfig(cfg.vocab, seq, batch_size), cfg)
    state = {"params": params, "opt": opt_state, "step": 0}
    for i in range(WARMUP + 1):
        batch = stream.shard(stream.batch(i), rt)
        if i == WARMUP:
            break
        state["params"], state["opt"], state["step"], _ = step_fn(
            state["params"], state["opt"], state["step"], batch)

    def run():
        state["params"], state["opt"], state["step"], m = step_fn(
            state["params"], state["opt"], state["step"], batch)
        return float(m["loss"])

    return run, "q8_both_wires" if args.q8 else f"param_store={args.store}"


def decode_step(cfg, args):
    """Prefill and warm a decode step up on the q8_block store with the
    int8 matmuls; returns a closure running one more decode step."""
    import numpy as np

    sched = CommSchedule(param_store="q8_block", serve_quant_matmul=True)
    model = build_model(cfg)
    rt = FSDPRuntime(model, init_local_group("nccl"),
                     compute_dtype=torch.bfloat16, schedule=sched)
    params = rt.init_params(0)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT))).to(rt.device)
    cache = model.init_cache(SERVE_BATCH, SERVE_LEN, device=rt.device)
    logits, cache = rt.make_prefill_step()(params, {"tokens": tokens}, cache)
    decode = rt.make_decode_step()
    state = {"tok": torch.argmax(logits, -1), "pos": SERVE_PROMPT}

    def run():
        lg, _ = decode(params, {"tokens": state["tok"]}, cache, state["pos"])
        state["tok"] = torch.argmax(lg, -1)
        state["pos"] += 1
        return float(lg.float().abs().mean())

    for _ in range(WARMUP):
        run()
    return run, "q8_serve_matmul decode"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=list(CONFIGS), default="gemma2")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--store", default="fp32",
                      choices=("fp32", "bf16", "fp8_e4m3", "fp8_e5m2",
                               "q8_block"),
                      help="the parameter store of every group")
    mode.add_argument("--q8", action="store_true",
                      help="the q8_block store and q8 gradient wire")
    mode.add_argument("--serve", action="store_true",
                      help="a decode step of the int8 serve mode")
    args = ap.parse_args()
    arch, layers, batch_size, seq, optimizer = CONFIGS[args.config]
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    full = get_config(arch)
    # one rank: expert parallelism off (the port runs ep=1)
    cfg = dataclasses.replace(full, n_layers=layers, parallel=dataclasses
                              .replace(full.parallel, ep=1),
                              optimizer=optimizer or full.optimizer)
    run, schedule = (decode_step if args.serve else train_step)(cfg, args)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        value = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device activity")
    # union of kernel intervals: the device's busy time in the step
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_cat: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        by_cat[category(e.name)] = by_cat.get(category(e.name), 0.0) + us
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += us
        row[1] += 1
    batch = [SERVE_BATCH, 1] if args.serve else [batch_size, seq]
    print(json.dumps({
        "phase": "profile", "model": cfg.name, "n_layers": layers,
        "optimizer": None if args.serve else cfg.optimizer,
        "schedule": schedule, "batch": batch, "compute": "bf16",
        "device": torch.cuda.get_device_name(0),
        ("mean_abs_logit" if args.serve else "loss"): value,
        "step_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_ms_by_category": {k: v / 1e3 for k, v in
                                  sorted(by_cat.items())},
        "kernel_launches": len(kernels)}), flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    for name, (us, count) in top:
        print(json.dumps({"kernel": name[:120], "category": category(name),
                          "ms": us / 1e3, "count": count}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
