"""Process groups: the port's mesh (counterpart of ``repro/launch/mesh.py``).

The reference builds a ``jax.sharding.Mesh``; the port's mesh is the
mapping ``{"data": world_size, "model": 1}`` together with a
``torch.distributed`` process group, which ``core.fsdp.FSDPRuntime`` takes.
Nothing here reads a cluster's environment: the caller names the backend,
the rank, the world size and the rendezvous file.
"""
from __future__ import annotations

import os
import tempfile
from datetime import timedelta

import torch.distributed as dist


def init_local_group(backend: str = "nccl", *, rank: int = 0,
                     world_size: int = 1, init_file: str | None = None):
    """Initialise (or reuse) this process's default process group over a
    ``FileStore`` and return it.

    ``backend`` is a ``torch.distributed`` backend string: ``"nccl"`` on
    the card (a one-rank NCCL group still runs the real collectives),
    ``"gloo"`` on the CPU, or ``"cpu:gloo,cuda:nccl"`` for a group that
    serves tensors on both.  A one-rank group needs no ``init_file``: it
    rendezvouses through a fresh temporary file.  A process whose default
    group already exists gets that group back, provided it has the same
    world size and rank."""
    if dist.is_initialized():
        if (dist.get_world_size() != world_size
                or dist.get_rank() != rank):
            raise RuntimeError(
                f"a process group of world size {dist.get_world_size()} "
                f"(rank {dist.get_rank()}) already exists; asked for "
                f"{world_size} (rank {rank})")
        return dist.group.WORLD
    if init_file is None:
        if world_size != 1:
            raise ValueError(
                "a multi-rank group needs an init_file shared by its ranks")
        fd, init_file = tempfile.mkstemp(prefix="repro_torch_pg_")
        os.close(fd)
        os.unlink(init_file)
    store = dist.FileStore(init_file, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=300))
    return dist.group.WORLD


def mesh_axes(group) -> dict[str, int]:
    """The mesh of ``group`` as ``{axis: size}`` (what the planner takes)."""
    return {"data": dist.get_world_size(group), "model": 1}


# Hardware constants of the cost model's builtin roofline (core.policy
# CostModel.default, core.profile.builtin_profile), per card: datasheet
# figures of the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, not
# measurements.  A card capped below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s: dense bf16 tensor cores (H100 SXM5, 700 W)
HBM_BW = 3.35e12          # B/s: HBM3 bandwidth (H100 SXM5, 700 W)
ICI_BW = 450e9            # B/s: NVLink 4, per direction (H100 SXM5, 700 W)
