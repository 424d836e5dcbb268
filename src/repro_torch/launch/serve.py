"""Batched serving from the command line: prefill, then greedy decode.

The port of ``repro/launch/serve.py``: prefill a batch of prompts, then
decode tokens greedily, with ZeRO-3 parameter gathering per layer
(parameters stay sharded at rest).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The reference's arguments, plus ``--device`` (``cuda``, the default, or
``cpu``).  ``--data N`` runs N ranks (one process each: gloo on the CPU,
NCCL with one card per rank); the batch is split over them.  ``--model``
above 1 (tensor parallelism) is not ported (ROADMAP Queue 1 item 18b).
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.model > 1:
        raise NotImplementedError(
            f"--model {args.model} (tensor parallelism) is not ported yet "
            f"(ROADMAP Queue 1 item 18b)")
    if args.data < 1 or args.gen < 1:
        raise ValueError("--data and --gen must be >= 1")
    return args


def serve(args, group) -> list:
    """One rank's run over ``group``; returns the generated tokens (B, gen)
    as lists and prints the timings (rank 0)."""
    import numpy as np
    import torch

    from ..configs import build_model, get_config
    from ..core.fsdp import FSDPRuntime

    device = args.device
    rank = torch.distributed.get_rank(group)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    runtime = FSDPRuntime(model, group, device=device)
    params = runtime.init_params(args.seed)
    prefill = runtime.make_prefill_step()
    decode = runtime.make_decode_step()

    rng = np.random.default_rng(args.seed)
    B, P = args.batch, args.prompt_len
    dev = runtime.device
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P))).to(dev)}
    cache = model.init_cache(B, P + args.gen, device=dev)
    say = print if rank == 0 else (lambda *a, **k: None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    nxt = torch.argmax(logits[:, -1], dim=-1)
    sync()
    say(f"prefill {B}x{P} in {time.perf_counter() - t0:.2f}s")

    out_tokens = [nxt]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = decode(params, {"tokens": nxt[:, None]}, cache,
                               P + i)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        out_tokens.append(nxt)
    sync()
    dt = time.perf_counter() - t0
    gen = torch.stack(out_tokens, 1).cpu().tolist()
    say(f"decoded {args.gen - 1} steps x batch {B} in {dt:.2f}s "
        f"({B * (args.gen - 1) / max(dt, 1e-9):.1f} tok/s)")
    say("sample continuations:")
    for b in range(min(B, 4)):
        say(f"  [{b}]", gen[b])
    return gen


def _rank_main(args, rank: int = 0, init_file: str | None = None):
    """Create this rank's process group (NCCL with card ``rank``, or gloo
    on the CPU), serve, and tear the group down."""
    import torch

    from .mesh import init_local_group

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "serve runs on the card by default and no CUDA device is "
                "available; pass --device cpu")
        torch.cuda.set_device(rank)
    group = init_local_group("nccl" if args.device == "cuda" else "gloo",
                             rank=rank, world_size=args.data,
                             init_file=init_file)
    try:
        serve(args, group)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if args.data == 1:
        _rank_main(args)
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(args, r, init_file))
                 for r in range(args.data)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"serve ranks exited with {codes}")


if __name__ == "__main__":
    main()
