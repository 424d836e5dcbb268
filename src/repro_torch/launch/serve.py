"""Batched serving from the command line: prefill, then greedy decode.

The port of ``repro/launch/serve.py``: prefill a batch of prompts, then
decode tokens greedily, with ZeRO-3 parameter gathering per layer
(parameters stay sharded at rest).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --reduced --batch 4 --prompt-len 32 --gen 16 [--device cpu]

The reference's arguments, plus ``--device`` (``cuda``, the default, or
``cpu``).  ``--data N --model M`` runs N x M ranks on a ``(data, model)``
mesh (one process each: gloo on the CPU, NCCL with one card per rank, so
a mesh of more ranks than cards is refused); the batch is split over the
data axis.  ``--model`` above 1 serves with tensor parallelism of that
degree over the model axis (``configs.with_tp``: FSDP and the batch over
the data axis), which needs more ranks than KV heads, as the reference's
cache does: a reduced config (as many KV heads as query heads) raises its
``ValueError``.  Every rank returns the whole vocabulary's logits, and
holds its own part of the cache (``FSDPRuntime.init_cache``);
``--cache-bytes`` prints that part's bytes beside the global cache's.
A VLM's prompt carries ``patches`` (B, n_patches, d_model) and an
encoder-decoder's ``frames`` (B, n_frames, d_model), bf16 normals drawn
after the tokens, as the reference's; every decode step gets them too.
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
    ap.add_argument("--cache-bytes", action="store_true",
                    help="print the serve cache bytes a rank holds (its "
                         "own part, and the global cache) for a batch of "
                         "--batch and --prompt-len + --gen positions, from "
                         "shapes on the meta device, and serve nothing")
    args = ap.parse_args(argv)
    if args.data < 1 or args.model < 1 or args.gen < 1:
        raise ValueError("--data, --model and --gen must be >= 1")
    return args


def serve_config(args):
    """The config ``args`` name: reduced or at published width, and with
    ``--model`` above 1 tensor parallel of that degree."""
    from ..configs import get_config, with_tp

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return with_tp(cfg, args.model) if args.model > 1 else cfg


def serve(cfg, args, group) -> list:
    """One rank's run of ``cfg`` (``serve_config(args)`` from the command
    line) over ``group``; returns the generated tokens (B, gen) as lists
    and prints the timings (rank 0)."""
    import numpy as np
    import torch

    from ..configs import build_model
    from ..core.fsdp import FSDPRuntime
    from .mesh import make_local_mesh

    device = args.device
    rank = torch.distributed.get_rank(group)
    model = build_model(cfg)
    mesh = make_local_mesh(args.data, args.model, group=group)
    runtime = FSDPRuntime(model, mesh, device=device)
    params = runtime.init_params(args.seed)
    prefill = runtime.make_prefill_step()
    decode = runtime.make_decode_step()

    rng = np.random.default_rng(args.seed)
    B, P = args.batch, args.prompt_len
    dev = runtime.device
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P))).to(dev)}
    if cfg.arch_type == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_patches, cfg.d_model))).to(torch.bfloat16).to(dev)
    if cfg.arch_type == "audio":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_frames, cfg.d_model))).to(torch.bfloat16).to(dev)
    cache = runtime.init_cache(B, P + args.gen)
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
        logits, cache = decode(params, {**batch, "tokens": nxt[:, None]},
                               cache, P + i)
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


def cache_bytes(cfg, args) -> dict:
    """The serve cache of ``cfg`` for a global batch of ``args.batch`` rows
    and ``args.prompt_len + args.gen`` positions, in bytes per rank, from
    tensors on the meta device: ``global`` the whole cache, ``rank`` one
    rank's part (``core.fsdp.local_cache_shapes``: its rows of the batch
    split over the data axis, where it divides, and under tp one KV head
    slot), per leaf (a nested cache's by its path, ``ssm/conv``; the
    encoder-decoder's ``memory`` beside its KV leaves) and in total."""
    import torch

    from ..configs import build_model
    from ..core.fsdp import local_cache_shapes
    from ..models.cache import leaves as cache_leaves

    model = build_model(cfg)
    B, W = args.batch, args.prompt_len + args.gen
    rows = B // args.data if B % args.data == 0 else B
    out = {}
    for what, shapes in (
            ("global", model.cache_shapes(B, W)),
            ("rank", local_cache_shapes(model, B, W, rows,
                                        cfg.parallel.tp))):
        leaves = {"/".join(path): torch.empty(shape, dtype=dtype,
                                              device="meta").nbytes
                  for path, (shape, dtype) in cache_leaves(shapes)}
        out[what] = {**leaves, "total": sum(leaves.values())}
    return out


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
        # a rank past the last card is refused by the mesh's check
        torch.cuda.set_device(rank % torch.cuda.device_count())
    group = init_local_group("nccl" if args.device == "cuda" else "gloo",
                             rank=rank, world_size=args.data * args.model,
                             init_file=init_file)
    try:
        serve(serve_config(args), args, group)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    if args.cache_bytes:
        import json

        print(json.dumps(cache_bytes(serve_config(args), args)))
        return
    world = args.data * args.model
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "serve runs on the card by default and no CUDA device is "
                "available; pass --device cpu")
    if world == 1:
        _rank_main(args)
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(args, r, init_file))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"serve ranks exited with {codes}")


if __name__ == "__main__":
    main()
