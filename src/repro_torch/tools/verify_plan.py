"""Verify the shipped configs' plans at 8 ranks (port of
``tools/verify_plan.py``).

For each architecture (its reduced geometry: the same family and
structure) and each schedule variant, build the runtime on meta tensors
over an 8-rank ``"fake"`` process group (the reference's 8-device host
mesh; ``(8 / tp, tp)`` for a config with a model axis), trace one train
step and prove every invariant the plan declares (``analysis``): wire
legs and byte totals, wire dtypes, ring-chunk snapping, the
gathered-buffer peak, fused decodes and EF threading.  Exits non-zero on
any violation.  Host only: nothing runs on a card.

``--break ring-chunk|wire-bytes`` shows the negative path: the runtime is
real, the plan it is verified against is tampered (a ring chunk one past
the quant block, which the wire's unit-1 snap and the block-aligned snap
disagree on; or a bf16 cast store where the step ships int8 codes and
fp32 scales).  The command exits 0 when the verifier reports the
violation, and non-zero when the tampered plan verifies clean.

    python -m repro_torch.tools.verify_plan --all
    python -m repro_torch.tools.verify_plan --config gemma2-2b --variant q8
    python -m repro_torch.tools.verify_plan --config gemma2-2b \\
        --break wire-bytes
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

WORLD = 8


def q8_schedule():
    """The q8 variant: ``overlap_all`` on the q8_block store with the q8
    reduce wire, a ring gather and the accumulate-in-flight ring reduce."""
    from ..core.schedule import VARIANTS

    return dataclasses.replace(
        VARIANTS["overlap_all"], param_store="q8_block",
        reduce_wire="q8_block", reduce_dtype=None, reduce_mode="ring_acc",
        gather_mode="ring")


def build_runtime(arch: str, variant: str):
    """The reduced ``arch`` on a meta runtime over the fake group of this
    process (``launch.mesh.fake_world(8)``), bf16 compute."""
    import torch

    from ..configs import build_model, get_config
    from ..core.fsdp import FSDPRuntime
    from ..core.schedule import VARIANTS
    from ..launch.mesh import make_fake_mesh

    cfg = get_config(arch).reduced()
    tp = max(1, cfg.parallel.tp, cfg.parallel.ep)
    sched = None
    if variant == "q8":
        sched = q8_schedule()
    elif variant != "default":
        sched = VARIANTS[variant]
    return FSDPRuntime(build_model(cfg),
                       make_fake_mesh({"data": WORLD // tp, "model": tp}),
                       schedule=sched, compute_dtype=torch.bfloat16,
                       device="meta")


def tamper(plan, mode: str):
    """A deliberately broken copy of ``plan`` (its largest group's
    policy changed) for the negative demos."""
    gname = max(plan.groups, key=lambda n: plan.groups[n].plan.total)
    e = plan.groups[gname]
    if mode == "ring-chunk":
        pol = dataclasses.replace(e.policy,
                                  ring_chunk_elems=e.quant_block + 1)
    elif mode == "wire-bytes":
        pol = dataclasses.replace(e.policy, store="bf16", reduce_wire=None)
    else:
        raise SystemExit(f"unknown --break mode {mode!r}")
    e2 = dataclasses.replace(e, policy=pol)
    return dataclasses.replace(plan, groups={**dict(plan.groups), gname: e2})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", default=None,
                    help="arch id (repeatable); see repro_torch.configs")
    ap.add_argument("--all", action="store_true",
                    help="verify every assigned arch")
    ap.add_argument("--variant", action="append", default=None,
                    choices=["default", "q8"],
                    help="schedule variants per arch (default: both)")
    ap.add_argument("--break", dest="break_mode", default=None,
                    choices=["ring-chunk", "wire-bytes"],
                    help="tamper the plan and demand a violation (one "
                         "--config, the q8 variant)")
    ap.add_argument("--profile", default=None,
                    help="comm profile path for the freshness check")
    return ap, ap.parse_args(argv)


def main(argv=None) -> int:
    from ..analysis import verify_runtime
    from ..configs import ASSIGNED_ARCH_IDS
    from ..launch.mesh import fake_world

    ap, args = parse_args(argv)
    archs = list(ASSIGNED_ARCH_IDS) if args.all else (args.config or [])
    if not archs:
        ap.error("pass --config <arch> or --all")

    with fake_world(WORLD):
        if args.break_mode:
            rt = build_runtime(archs[0], "q8")
            report = verify_runtime(rt, plan=tamper(rt.plan,
                                                    args.break_mode))
            print(report.summary())
            if report.ok:
                print(f"--break {args.break_mode}: tampered plan verified "
                      f"clean -- the verifier has no teeth",
                      file=sys.stderr)
                return 1
            print(f"--break {args.break_mode}: violation detected as "
                  f"expected")
            return 0

        failed = 0
        for arch in archs:
            for variant in args.variant or ["default", "q8"]:
                rt = build_runtime(arch, variant)
                report = verify_runtime(rt, profile_path=args.profile)
                status = "ok" if report.ok else "FAIL"
                print(f"[{status}] {arch} variant={variant}: "
                      f"{len(report.checked)} invariants, "
                      f"{len(report.errors)} violations, "
                      f"{len(report.warnings)} warnings")
                for v in report.violations:
                    print(f"  {v}")
                failed += not report.ok
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
