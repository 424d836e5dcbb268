"""Comm calibration: time every wire codec x gather/reduce route x ring
chunk over a process group and save a ``comm-profile/v1``
(``core.profile``) that ``CostModel.from_profile`` prices
``policies="auto"`` with (port of ``benchmarks/bench_comm.py``).

    PYTHONPATH=src python -m repro_torch.launch.bench_comm --out PATH \\
        [--quick] [--device cuda|cpu]

Entries are end to end, as the reference's: a q8_block gather is the
payload's all-gather plus ``ops.dequantize_into``; a q8_block reduce is the
encode (``ops.quantize``), the route and the decode.  The routes are the
port's ``core.wire`` ones: ``payload_all_gather`` (xla, ring) and
``codec_reduce_scatter`` (xla, ring, ring_acc).  On the card the group is
NCCL at whatever world size the caller started (one rank with no
arguments: then no ring hop runs and the entries time the codecs and the
collective's issue); on the CPU it is gloo.  With more ranks, launch one
process per rank and pass ``--rank``, ``--world`` and ``--init-file``;
rank 0 writes ``--out``.  Times are the median over ``iters`` calls of the
host clock around the call and a device synchronize.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.profile import CommProfile, CommSample
from ..core.wire import WireCodec, codec_reduce_scatter, payload_all_gather

BLOCK = 1024
FMTS = ("fp32", "bf16", "q8_block")
# profile mode -> (gather mode, reduce mode) of the wire layer
REDUCE_ROUTES = {"xla": ("xla", "match"), "ring": ("ring", "match"),
                 "ring_acc": ("ring", "ring_acc")}


def _chunk_sweep(shard: int) -> list:
    """Ring-chunk candidates below the shard-sized default, q8-block
    aligned so one sweep serves every format."""
    return [shard // k for k in (2, 4, 8)
            if shard // k >= BLOCK and shard % (k * BLOCK) == 0]


def _timeit(fn, device, iters: int, warmup: int) -> float:
    """Median microseconds of ``fn()`` over ``iters`` calls."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def run(group, device, *, quick: bool = False, out: str | None = None,
        sizes=None, verbose: bool = True) -> CommProfile:
    """Time the port's routes over ``group`` on ``device`` and return the
    profile (saved to ``out`` by rank 0 when given)."""
    device = torch.device(device)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if sizes is None:
        sizes = (1 << 16, 1 << 18) if quick else (1 << 18, 1 << 21)
    iters = 3 if quick else 10
    warmup = 1 if quick else 3
    f32 = torch.float32
    entries = []

    def sample(direction, fmt, mode, elems, chunk, us):
        # chunk_elems == elems marks the shard-sized default
        entries.append(CommSample(direction=direction, fmt=fmt, mode=mode,
                                  elems=elems,
                                  chunk_elems=elems if chunk is None
                                  else chunk, time_us=us))
        if verbose and rank == 0:
            print(f"comm/{direction}/{fmt}/{mode},{us:.3f},elems={elems};"
                  f"chunk={'shard' if chunk is None else chunk}",
                  flush=True)

    def gather_fn(fmt, mode, chunk, x, q8):
        codec = WireCodec(fmt, BLOCK)
        if not codec.quantized:
            # a flat store: encode, gather, decode to fp32
            return lambda: codec.decode(payload_all_gather(
                codec.encode(x), group, mode, chunk), f32)
        # a q8 store holds its payload: gather codes and scales, decode
        return lambda: codec.decode({
            "codes": payload_all_gather(q8["codes"], group, mode, chunk),
            "scales": payload_all_gather(
                q8["scales"], group, mode,
                max(chunk // BLOCK, 1) if chunk else None)}, f32)

    def reduce_fn(fmt, mode, chunk, ct):
        codec = WireCodec(fmt, BLOCK)
        gmode, rmode = REDUCE_ROUTES[mode]
        return lambda: codec_reduce_scatter(ct, None, codec, group, f32,
                                            gmode, rmode, chunk)

    rng = np.random.default_rng(rank)
    for elems in sizes:
        shard = elems // n
        x = torch.from_numpy(
            rng.normal(size=shard).astype(np.float32)).to(device)
        ct = torch.from_numpy(
            rng.normal(size=elems).astype(np.float32)).to(device)
        q8 = WireCodec("q8_block", BLOCK).encode(x)
        sweep = _chunk_sweep(shard) if (n > 1 and elems == max(sizes)) \
            else []
        for fmt in FMTS:
            for mode in ("xla", "ring"):
                for c in [None] + (sweep if mode == "ring" else []):
                    us = _timeit(gather_fn(fmt, mode, c, x, q8), device,
                                 iters, warmup)
                    sample("gather", fmt, mode, elems, c, us)
            for mode in REDUCE_ROUTES:
                for c in [None] + (sweep if mode != "xla" else []):
                    us = _timeit(reduce_fn(fmt, mode, c, ct), device, iters,
                                 warmup)
                    sample("reduce", fmt, mode, elems, c, us)

    prof = CommProfile(
        name=f"measured-{device.type}-{n}dev" + ("-quick" if quick else ""),
        entries=tuple(entries), backend=device.type, world=n,
        builtin=False, end_to_end=True, quick=quick)
    if out is not None and rank == 0:
        prof.save(out)
        if verbose:
            print(f"comm/profile,0,wrote {out};name={prof.name};"
                  f"hash={prof.content_hash()}", flush=True)
    return prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="where to write the profile (JSON)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller sizes and fewer iterations")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--init-file", default=None,
                    help="rendezvous file shared by the ranks")
    args = ap.parse_args(argv)
    from .mesh import init_local_group

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(
                "bench_comm runs on the card by default and no CUDA device "
                "is available; pass --device cpu")
        torch.cuda.set_device(args.rank)
    group = init_local_group("nccl" if args.device == "cuda" else "gloo",
                             rank=args.rank, world_size=args.world,
                             init_file=args.init_file)
    print("name,us_per_call,derived")
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device("cpu"))
    run(group, device, quick=args.quick, out=args.out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
