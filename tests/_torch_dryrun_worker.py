"""The dry runs of ``tests/test_torch_dryrun.py``, in processes of their
own: a dry run makes its own fake default process group, which a test
process that already holds a gloo group cannot.  ``PART`` (0, 1 or 2)
picks a third of them by their host seconds, so that the test runs the
three at once; each prints one JSON object on the line that starts with
``RESULT`` and appends its rows to ``OUT_DIR/rows<PART>.jsonl``.

    PYTHONPATH=src python tests/_torch_dryrun_worker.py OUT_DIR PART
"""
import dataclasses
import json
import pathlib
import sys

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun


def record_of(rec, plan) -> dict:
    return {"flops": rec.flops, "bytes": rec.bytes,
            "collectives": rec.collectives, "arg_bytes": rec.arg_bytes,
            "temp_peak": rec.temp_peak, "kernels": rec.kernel_calls(),
            "groups": {n: {"gather": e.gather_wire_bytes(plan.compute_dtype),
                           "reduce": e.reduce_wire_bytes(plan.compute_dtype),
                           "n_layers": e.n_layers, "total": e.plan.total,
                           "shard": e.plan.shard_size, "m": e.fsdp_world}
                       for n, e in plan.groups.items()}}


def reduced_and_recurrent(res: dict, argv: list) -> None:
    """The reduced 4 x 2 steps, qwen3-moe on a pod mesh, xLSTM at
    published width, and the full-width gemma2-2b row."""
    gemma = get_config("gemma2-2b")
    reduced = dataclasses.replace(gemma.reduced(), parallel=gemma.parallel)
    mesh = {"data": 4, "model": 2}
    for kind, T, B in (("train", 32, 8), ("prefill", 32, 8),
                       ("decode", 32, 8)):
        res[f"reduced_{kind}"] = record_of(*dryrun.dry_step(
            reduced, ShapeConfig(kind, T, B, kind), mesh))
    ring = dataclasses.replace(reduced, parallel=dataclasses.replace(
        gemma.parallel, gather_mode="ring"))
    res["reduced_ring"] = record_of(*dryrun.dry_step(
        ring, ShapeConfig("train", 32, 8, "train"), mesh))
    moe = get_config("qwen3-moe-235b-a22b")
    moe_reduced = dataclasses.replace(moe.reduced(), parallel=dataclasses
                                      .replace(moe.parallel, ep=2))
    res["moe_pod"] = record_of(*dryrun.dry_step(
        moe_reduced, ShapeConfig("train", 16, 8, "train"),
        {"pod": 2, "data": 2, "model": 2}))
    # the recurrent families at published width on the production mesh:
    # xLSTM's train step at 130 tokens a row (two mLSTM chunks, the second
    # padded; its sLSTM loops over the sequence op by op on meta tensors,
    # so train_4k takes minutes) and its decode of one token a row
    # against the nested cache
    prod = {"data": 16, "model": 16}
    xlstm = get_config("xlstm-125m")
    res["xlstm_train"] = record_of(*dryrun.dry_step(
        xlstm, ShapeConfig("train_130", 130, 256, "train"), prod))
    res["xlstm_decode"] = record_of(*dryrun.dry_step(
        xlstm, ShapeConfig("decode_32k", 32768, 128, "decode"), prod))
    # the full-width row proves its plan's invariants from the same step
    res["full"] = dryrun.main(["--arch", "gemma2-2b", "--shape", "train_4k",
                               "--verify", *argv])[0]


def hymba_rows(res: dict, argv: list) -> None:
    """hymba-1.5b's train_4k and long_500k rows."""
    res["hymba"] = dryrun.main(["--arch", "hymba-1.5b", "--shape",
                                "train_4k", *argv])[0]
    res["hymba_long"] = dryrun.main(["--arch", "hymba-1.5b", "--shape",
                                     "long_500k", *argv])[0]


def seamless_and_skip(res: dict, argv: list) -> None:
    """seamless-m4t-medium's train_4k row and a skip row."""
    res["seamless"] = dryrun.main(["--arch", "seamless-m4t-medium",
                                   "--shape", "train_4k", *argv])[0]
    res["skip"] = dryrun.main(["--arch", "qwen2.5-14b", "--shape",
                               "long_500k", "--multi-pod", *argv])[0]


# in this order, their rows make the test's ``written`` list
PARTS = (reduced_and_recurrent, hymba_rows, seamless_and_skip)


def main(out_dir: str, part: int) -> None:
    out = pathlib.Path(out_dir) / f"rows{part}.jsonl"
    res = {}
    PARTS[part](res, ["--out", str(out)])
    res["written"] = [json.loads(l) for l in out.read_text().splitlines()]
    print("RESULT " + json.dumps(res))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
