"""The cost model's ``policies="auto"`` decisions for every registered config
(host only: planning needs no device).

    PYTHONPATH=src python -m repro_torch.launch.auto_decisions \\
        [--data 8 64] [--ici-bw B/s --hbm-bw B/s --peak-flops FLOP/s]

Prints, per config (at tp = ep = 1: the port has no model axis yet) and
data-axis size, each group's store, gather mode, reduce wire and whether
it is sharded, as a markdown table, under the builtin roofline over
``launch.mesh``'s constants (the H100's datasheet figures) or over the
rates given on the command line.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..configs import ARCH_IDS, build_model, get_config
from ..core.policy import CostModel, plan


def decisions(data_sizes=(8, 64), cost_model: CostModel | None = None
              ) -> dict:
    """``{(arch, data): {group: (store, gather mode, reduce wire or
    "cast", "sharded" or "replicated")}}``."""
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, tp=1, ep=1, sequence_parallel=False))
        model = build_model(cfg)
        for d in data_sizes:
            p = plan(model, {"data": d}, "auto", cost_model=cost_model)
            out[arch, d] = {
                n: (e.policy.store, e.policy.gather_mode,
                    e.policy.reduce_wire or "cast",
                    "sharded" if e.policy.sharded else "replicated")
                for n, e in p.groups.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=int, nargs="+", default=[8, 64])
    ap.add_argument("--ici-bw", type=float, default=None)
    ap.add_argument("--hbm-bw", type=float, default=None)
    ap.add_argument("--peak-flops", type=float, default=None)
    args = ap.parse_args(argv)
    cm = CostModel.default()
    cm = dataclasses.replace(
        cm, ici_bw=args.ici_bw or cm.ici_bw, hbm_bw=args.hbm_bw or cm.hbm_bw,
        peak_flops=args.peak_flops or cm.peak_flops)
    print(f"ici_bw={cm.ici_bw:g} hbm_bw={cm.hbm_bw:g} "
          f"peak_flops={cm.peak_flops:g}")
    print("| config | data | group | store | gather | reduce wire | sharded |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for (arch, d), groups in decisions(tuple(args.data), cm).items():
        for g, (store, mode, wire, sh) in groups.items():
            print(f"| {arch} | {d} | {g} | {store} | {mode} | {wire} | "
                  f"{sh} |")


if __name__ == "__main__":
    main()
