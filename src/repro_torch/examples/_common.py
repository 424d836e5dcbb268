"""What the port's examples share: the ``--device`` flag and a one-rank
mesh."""
from __future__ import annotations

import argparse
import contextlib

import torch
import torch.distributed as dist

from ..launch.mesh import init_local_group, make_local_mesh

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the example runs: the card (the default; "
                         "raises without one) or the CPU")
    ap.add_argument("--compute-dtype", choices=tuple(COMPUTE_DTYPES),
                    default="bfloat16",
                    help="the runtime's compute dtype (bfloat16, the "
                         "reference's default; float32 for parity runs)")
    return ap


@contextlib.contextmanager
def local_mesh(device: str):
    """The example's one-rank ``(1, 1)`` mesh: over the process's default
    group when it has one (of one rank), else over a new one -- NCCL on
    the card, gloo on the CPU -- destroyed on exit."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the examples run on the card by default and no CUDA device is "
            "available; pass --device cpu to run on the CPU")
    created = not dist.is_initialized()
    init_local_group("nccl" if device == "cuda" else "gloo")
    try:
        yield make_local_mesh(1, 1)
    finally:
        if created:
            dist.destroy_process_group()
