"""End-to-end training from the command line (port of
``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

The command wires the data stream, the FSDP runtime (the planner, the
sharding policies and the comm profile that prices ``--policies auto``),
the optimizer, the metrics and periodic checkpoints; ``--resume``
continues from ``--ckpt`` at any saved plan, mesh or TP degree (a load
across layouts streams through the extent map).  The reference's
arguments, defaults and printed lines -- the plan's ``describe()`` table,
``arch=... params=...M planner=... optimizer=... mesh={...}``, ``step N
loss X gnorm Y tok/s Z`` and the checkpoint lines -- plus ``--device``
(``cuda``, the default, or ``cpu``): without a card the default raises.
``--data N --model M`` runs N x M ranks on a ``(data, model)`` mesh, one
process each (gloo on the CPU, NCCL with one card per rank, so a mesh of
more ranks than cards is refused); rank 0 prints.  ``--tp`` sets the
config's tensor-parallel degree (``configs.with_tp``: FSDP and the batch
leave the model axis).  ``--verify`` proves the plan's declared invariants
against one step of a meta twin of the runtime before the first step
(``analysis.verify_runtime``: nothing runs on the card) and prints the
report; a violation raises ``VerificationError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import pathlib
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data", type=int, default=1, help="data axis size")
    ap.add_argument("--model", type=int, default=1, help="model axis size")
    ap.add_argument("--planner", default="ragged")
    ap.add_argument("--policies", default=None,
                    help="sharding policies: 'auto' runs the structure-"
                         "aware cost model per group (core.policy); default "
                         "lowers the config's legacy knobs")
    ap.add_argument("--profile", default=None,
                    help="measured comm profile JSON (launch.bench_comm): "
                         "'--policies auto' prices formats and ring "
                         "chunking from its curves instead of the builtin "
                         "roofline")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore params/opt state from --ckpt if it exists "
                         "(any saved plan/mesh/TP degree: cross-plan loads "
                         "stream through the extent map) and continue from "
                         "the saved step")
    ap.add_argument("--tp", type=int, default=0,
                    help="override the arch config's tensor-parallel degree "
                         "(requires --model >= the degree)")
    ap.add_argument("--verify", action="store_true",
                    help="statically verify the plan's declared comm/memory/"
                         "dtype invariants against the traced step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.data < 1 or args.model < 1:
        raise ValueError("--data and --model must be >= 1")
    return args


def train_config(args):
    """The config ``args`` name: reduced or at published width, the
    optimizer override, and ``--tp`` (1: no tensor parallelism; above 1:
    ``configs.with_tp``)."""
    from ..configs import get_config, with_tp

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.optimizer:
        cfg = dataclasses.replace(cfg, optimizer=args.optimizer)
    if args.tp > 1:
        cfg = with_tp(cfg, args.tp)
    elif args.tp == 1:
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, tp=1))
    return cfg


def train(cfg, args, group) -> dict:
    """One rank's run of ``cfg`` (``train_config(args)``) over ``group``;
    prints the reference's lines (rank 0) and returns ``{"loss": [...],
    "grad_norm": [...], "step_ms": [...], "setup_s": s, "start": step,
    "groups": [...], "verify": {...} or None}``: each step's metrics and
    host time (to a synchronised end on the card), the seconds from the
    runtime's construction to the first step (verification included), the
    step it started from, the plan's groups and, with ``--verify``, the
    report's counts and seconds."""
    import torch

    from ..checkpoint import ckpt
    from ..configs import build_model
    from ..core.fsdp import FSDPRuntime
    from ..data.pipeline import DataConfig, SyntheticStream
    from ..optim import make_optimizer
    from .mesh import make_local_mesh

    rank = torch.distributed.get_rank(group)
    say = print if rank == 0 else (lambda *a, **k: None)
    t_setup = time.perf_counter()
    mesh = make_local_mesh(args.data, args.model, group=group)
    model = build_model(cfg)
    cost_model = None
    if args.profile:
        from ..core.policy import CostModel

        cost_model = CostModel.from_profile(args.profile)
    runtime = FSDPRuntime(model, mesh, planner=args.planner,
                          policies=args.policies, cost_model=cost_model,
                          device=args.device)
    say(runtime.plan.describe())
    optimizer = make_optimizer(cfg)
    verified = None
    if args.verify:
        from ..analysis import verify_runtime

        t_v = time.perf_counter()
        report = verify_runtime(runtime, optimizer,
                                profile_path=args.profile)
        say(report.summary())
        report.raise_if_failed()
        verified = {"checked": len(report.checked),
                    "errors": len(report.errors),
                    "warnings": len(report.warnings),
                    "seconds": time.perf_counter() - t_v}
    params = runtime.init_params(args.seed)
    opt_state = optimizer.init(runtime)
    start = 0
    if args.resume and args.ckpt:
        if (pathlib.Path(args.ckpt) / "meta.json").exists():
            params, start, opt_state = ckpt.load(args.ckpt, runtime,
                                                 opt_state)
            say(f"resumed {args.ckpt} @ step {start}")
    step_fn = runtime.make_train_step(optimizer)
    stream = SyntheticStream(
        DataConfig(cfg.vocab, args.seq, args.batch, seed=args.seed), cfg)

    n_params = sum(
        int(lo.plan.payload) * (lo.n_layers or 1) * lo.outer_size
        for lo in runtime.layouts.values())
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"planner={args.planner} optimizer={cfg.optimizer} "
        f"mesh={dict(mesh.axis_sizes)}")

    def sync():
        if runtime.device.type == "cuda":
            torch.cuda.synchronize(runtime.device)

    sync()
    out = {"loss": [], "grad_norm": [], "step_ms": [], "start": start,
           "setup_s": time.perf_counter() - t_setup,
           "groups": list(runtime.layouts), "verify": verified}
    step = start
    t0 = time.time()
    for i in range(start, args.steps):
        batch = stream.shard(stream.batch(i), runtime)
        t_step = time.perf_counter()
        params, opt_state, step, metrics = step_fn(
            params, opt_state, step, batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        sync()
        out["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        out["loss"].append(loss)
        out["grad_norm"].append(gnorm)
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = time.time() - t0
            tok_s = (i + 1) * args.batch * args.seq / max(dt, 1e-9)
            say(f"step {i:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                f"tok/s {tok_s:,.0f}")
        if args.ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, runtime, params, opt_state, step=i + 1)
            say(f"checkpoint @ step {i+1} -> {args.ckpt}")
    if args.ckpt:
        ckpt.save(args.ckpt, runtime, params, opt_state, step=args.steps)
        say(f"final checkpoint -> {args.ckpt}")
    return out


def _check_device(args) -> None:
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(
                "train runs on the card by default and no CUDA device is "
                "available; pass --device cpu")


def _rank_main(args, rank: int = 0, init_file: str | None = None):
    """Create this rank's process group (NCCL with card ``rank``, or gloo
    on the CPU) unless the process has one, train, and tear down the group
    it made; returns ``train``'s result."""
    import torch

    from .mesh import init_local_group

    _check_device(args)
    if args.device == "cuda":
        # a rank past the last card is refused by the mesh's check
        torch.cuda.set_device(rank % torch.cuda.device_count())
    made = not torch.distributed.is_initialized()
    group = init_local_group("nccl" if args.device == "cuda" else "gloo",
                             rank=rank, world_size=args.data * args.model,
                             init_file=init_file)
    try:
        return train(train_config(args), args, group)
    finally:
        if made:
            torch.distributed.destroy_process_group()


def main(argv=None):
    """Train as the arguments say; on one rank in this process (reusing its
    process group when it has one) and returns ``train``'s result, on more
    in as many spawned processes (returns None)."""
    args = parse_args(argv)
    _check_device(args)
    world = args.data * args.model
    if world == 1:
        return _rank_main(args)
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
        raise SystemExit(f"train ranks exited with {codes}")
    return None


if __name__ == "__main__":
    main()
