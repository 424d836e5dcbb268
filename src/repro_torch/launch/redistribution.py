"""What one step of Muon's or Shampoo's layer-axis redistribution moves and
computes on a rank (``optim.common.redistribute``), from the plan alone.

    PYTHONPATH=src python -m repro_torch.launch.redistribution \\
        [--arch nemotron-4-340b] [--reduced] [--data 16] [--model 16] \\
        [--pod N] [--tp T]

Per stacked group with 2-D tensors, the fp32 bytes a rank receives from
the three all-gathers of a step -- the momentum (Muon) or gradient
(Shampoo) shard over the group's FSDP axes (``cols``), the model ranks'
parts of each split matrix to assemble it whole (``model``), the updates
along the layer axis (``rows``) -- the whole matrices it preconditions,
and Newton-Schulz's fp32 operations on them (five quintic steps of ``X
(a, b)``, a <= b: ``5 (4 a^2 b + 2 a^3)`` each).  Every rank of a model
or pod axis the group is not sharded over repeats the same matrices.  The
config's own tp unless ``--tp`` overrides it; host only.
"""
from __future__ import annotations

import argparse
import json
import math


def redistribution(cfg, mesh: dict) -> dict:
    """``{group: {"cols", "model", "rows": bytes received, "matrices":
    whole matrices preconditioned, "ns_flop": Newton-Schulz operations},
    "total": the same summed}`` per rank for ``cfg`` on ``mesh``."""
    from ..configs import build_model
    from ..core.policy import plan

    model = build_model(cfg)
    gdefs = model.groups()
    out = {}
    for name, e in plan(model, mesh).groups.items():
        mats = [s for s in e.local_specs if len(s.shape) == 2]
        if e.n_layers is None or not mats:
            continue
        m = math.prod(e.fsdp_axis_sizes) or 1
        L, n = e.n_layers, e.outer_size
        l_loc = -(-L // m)
        got = {"cols": (m - 1) * L * e.plan.shard_size * 4, "model": 0,
               "rows": 0, "matrices": 0, "ns_flop": 0}
        for s in mats:
            part = math.prod(s.shape)
            got["rows"] += (m - 1) * l_loc * part * 4
            whole = list(s.shape)
            sd = gdefs[name].outer.get(s.name)
            if sd is not None and n > 1:
                got["model"] += (n - 1) * l_loc * part * 4
                whole[sd.dim] *= n
            a, b = sorted(whole)
            got["matrices"] += l_loc
            got["ns_flop"] += l_loc * 5 * (4 * a * a * b + 2 * a ** 3)
        out[name] = got
    out["total"] = {k: sum(g[k] for g in out.values())
                    for k in ("cols", "model", "rows", "matrices",
                              "ns_flop")}
    return out


def main(argv=None) -> None:
    import dataclasses

    from ..configs import get_config, with_tp

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="nemotron-4-340b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--data", type=int, default=16)
    ap.add_argument("--model", type=int, default=16)
    ap.add_argument("--pod", type=int, default=0)
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--optimizer", default="muon")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, optimizer=args.optimizer)
    if args.tp:
        cfg = with_tp(cfg, args.tp) if args.tp > 1 else dataclasses.replace(
            cfg, parallel=dataclasses.replace(cfg.parallel, tp=1))
    mesh = {"data": args.data, "model": args.model}
    if args.pod:
        mesh = {"pod": args.pod, **mesh}
    print(json.dumps({"arch": cfg.name, "mesh": mesh,
                      "tp": cfg.parallel.tp, **redistribution(cfg, mesh)}))


if __name__ == "__main__":
    main()
