"""Device times of the serve path's ``q8_matmul`` and 8-bit Adam's flat
epilogue at the main path's shapes, for comparing two trees on one card.

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--label L]
    PYTHONPATH=<other checkout>/src python src/repro_torch/launch/kernel_bench.py

Only the public ``ops`` entry points and their plain versions are called,
so the same script times the ``repro_torch`` found first on the path (an
older checkout's kernels too).  Inputs come from fixed seeds on the card.

  * ``q8_matmul``: gemma2-2b's eligible weights of one layer (wq, wk, wv,
    w1, w3; block 1024, bf16 x and out) at M = 4 (one decode step) and
    M = 2048 (one prefill of 4 x 512): the device time of one call as
    CUDA-graph replays, the bound (the codes' bytes or the int8 operations
    at 1,979 TOP/s), ``torch._int_mm`` on the same int8 operands at M =
    2048, and the result bitwise against the plain version.
  * ``adam8bit_store_update`` (fp32 and bf16 flat epilogues): in place at
    qwen3-moe's full ``layers_experts`` and ``globals`` shards, and the bf16
    store (bf16 w and g) at gemma2-2b's adam8bit shards at 4 layers: CUDA
    events over whole calls, against the byte bound at 3.35 TB/s.

  * ``--serve``: the int8 serve mode's prefill end to end -- gemma2-2b at
    published width cut to 4 layers on the q8_block store with
    ``serve_quant_matmul``, 4 x 512 prompt tokens into a 1024-slot cache
    (``chip_smoke.py``'s ``serve`` phase): host ms around calls that end in
    a synchronise, median of 5 after a warm-up.

One JSON line per measurement, then the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess

import torch

from repro_torch.kernels import ops, ref

HBM_BYTES_PER_S = 3.35e12
INT8_OPS = 1979e12
BLOCK = 1024
# gemma2-2b's eligible (K, N) of one layer -> calls per layer
LAYER_Q8MM = {(2304, 2048): 1, (2304, 1024): 2, (2304, 9216): 2}
Q8MM_M = (4, 2048)
# (shape, store): qwen3-moe's full shards (fp32 store) and gemma2-2b's
# adam8bit-plan shards at 4 layers (bf16 store); both stores at qwen3's
ADAM8_CASES = (((1, 2_415_919_104), "fp32"), ((1_244_663_808,), "fp32"),
               ((1, 2_415_919_104), "bf16"), ((1_244_663_808,), "bf16"),
               ((4, 77_869_056), "bf16"), ((589_827_072,), "bf16"))
# bytes an element: w, g in, w' out (4 or 2 B each), m8, v8 in and out
ADAM8_ELEM_BYTES = {"fp32": 16, "bf16": 10}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def events_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()``: the median over ``iters`` replays of a
    CUDA graph of ``reps`` back-to-back calls, over ``reps``.  A call small
    enough that the host's launch path (one graph launch included)
    outlasts its kernels is measured on the device alone."""
    fn()                                   # build, load, allocate first
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = events_ms(graph.replay, iters) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


def bench_q8mm(label: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(6)
    per_layer = {m: {"ms": 0.0, "bound_ms": 0.0, "int_mm_ms": 0.0}
                 for m in Q8MM_M}
    for (k, n), calls in LAYER_Q8MM.items():
        codes = torch.randint(-127, 128, (k, n), generator=gen,
                              device="cuda", dtype=torch.int8)
        scales = torch.rand(k * n // BLOCK, generator=gen,
                            device="cuda") * 0.02 + 1e-3
        for m in Q8MM_M:
            x = (torch.randn(m, k, generator=gen, device="cuda")
                 * 2.0).to(torch.bfloat16)
            got = ops.q8_matmul(x, codes, scales, BLOCK)
            want = ref.q8_matmul_ref(x, codes, scales, BLOCK)
            torch.cuda.synchronize()
            bitwise = torch.equal(got.view(torch.int16),
                                  want.view(torch.int16))
            ms = graph_ms(lambda: ops.q8_matmul(x, codes, scales, BLOCK))
            nbytes = m * k * 2 + k * n + 4 * (k * n // BLOCK) + m * n * 2
            nops = 2 * m * k * n
            bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / INT8_OPS) * 1e3
            row = {"bench": "q8_matmul", "label": label, "M": m, "K": k,
                   "N": n, "ms": ms, "bound_ms": bound_ms,
                   "share_of_bound": bound_ms / ms,
                   "achieved_TOPs": nops / ms / 1e9, "bitwise": bitwise}
            if m > 16:
                a8 = torch.randint(-127, 128, (m, k), generator=gen,
                                   device="cuda", dtype=torch.int8)
                row["int_mm_ms"] = graph_ms(lambda: torch._int_mm(a8, codes))
                per_layer[m]["int_mm_ms"] += calls * row["int_mm_ms"]
                del a8
            emit(row)
            per_layer[m]["ms"] += calls * ms
            per_layer[m]["bound_ms"] += calls * bound_ms
            del x, got, want
        del codes, scales
        torch.cuda.empty_cache()
    for m, st in per_layer.items():
        emit({"bench": "q8_matmul_layer", "label": label, "M": m, **st})


def bench_adam8(label: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(7)
    kw = dict(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, wd=0.1, c1=1 - 0.9 ** 3,
              c2=1 - 0.95 ** 3)
    for shape, store in ADAM8_CASES:
        dtype = torch.float32 if store == "fp32" else torch.bfloat16
        n = math.prod(shape)
        sshape = shape[:-1] + (shape[-1] // BLOCK,)
        w = (torch.randn(shape, generator=gen, device="cuda") * 0.05).to(dtype)
        g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(dtype)
        m8 = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        v8 = torch.randint(0, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ms = torch.rand(sshape, generator=gen, device="cuda") * 1e-6
        vs = torch.rand(sshape, generator=gen, device="cuda") * 1e-7
        mask = (torch.rand(shape[-1], generator=gen, device="cuda")
                < 0.8).to(torch.uint8)
        out = (w, m8, v8, ms, vs)
        t = events_ms(lambda: ops.adam8bit_store_update(
            w, g, m8, v8, ms, vs, mask, fmt=store, block=BLOCK, out=out,
            **kw), iters=5)
        nbytes = n * ADAM8_ELEM_BYTES[store] + n // BLOCK * 16 + shape[-1]
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        emit({"bench": "adam8bit_flat", "label": label, "store": store,
              "shape": list(shape), "ms": t, "bound_ms": bound_ms,
              "share_of_bound": bound_ms / t})
        del w, g, m8, v8, ms, vs, mask, out
        torch.cuda.empty_cache()


def bench_serve_prefill(label: str) -> None:
    import dataclasses
    import time

    import numpy as np

    from repro_torch.configs import build_model, get_config
    from repro_torch.core.fsdp import FSDPRuntime
    from repro_torch.core.schedule import CommSchedule
    from repro_torch.launch.mesh import init_local_group

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=4)
    model = build_model(cfg)
    rt = FSDPRuntime(model, init_local_group("nccl"),
                     compute_dtype=torch.bfloat16,
                     schedule=CommSchedule(param_store="q8_block",
                                           serve_quant_matmul=True))
    params = rt.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 512))).cuda()
    cache = rt.init_cache(4, 1024)
    prefill = rt.make_prefill_step()
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens}, cache)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    emit({"bench": "serve_prefill", "label": label, "layers": 4,
          "batch": [4, 512], "ms": statistics.median(times), "ms_all": times})
    torch.distributed.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--serve", action="store_true",
                    help="also time the int8 serve mode's prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench needs a CUDA card")
    bench_q8mm(args.label)
    bench_adam8(args.label)
    if args.serve:
        bench_serve_prefill(args.label)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
