"""Process groups: the port's mesh (counterpart of ``repro/launch/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` of ``(data, model)`` devices,
or of ``(pod, data, model)`` with a pod axis (HSDP: parameters replicated
across pods, gradients all-reduced over them); the port's is a ``Mesh``
over one ``torch.distributed`` world: rank ``r`` sits at ``(data, model) =
(r // model, r % model)``, or at ``(pod, data, model)`` row-major, the
reference's device order.  Every axis subset the runtime uses has one
process group per row, made once by ``dist.new_group`` on every rank in
one fixed order.  ``core.fsdp.FSDPRuntime`` takes a ``Mesh``, or a bare
process group as the mesh ``{"data": world_size, "model": 1}``.  Nothing
here reads a cluster's environment: the caller names the backend, the
rank, the world size and the rendezvous file.
"""
from __future__ import annotations

import itertools
import math
import os
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

# the mesh's axes, outermost first (the reference's ``make_local_mesh``); a
# mesh without a pod axis has the last two
AXES = ("pod", "data", "model")


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


class Mesh:
    """A ``(data, model)`` or ``(pod, data, model)`` mesh over the ranks of
    ``group`` (the default group when None).  ``axis_sizes`` maps each axis
    to its size (``pod`` only when given), ``coords`` this rank's index on
    each; ``group_for(axes)`` is the process group of the ranks that share
    this rank's indices on every other axis, whose group ranks run
    row-major over ``axes`` (the reference's linear index over a tuple of
    mesh axes)."""

    def __init__(self, data: int, model: int = 1, group=None,
                 pod: int | None = None):
        self.group = dist.group.WORLD if group is None else group
        world = dist.get_world_size(self.group)
        sizes = {"data": data, "model": model}
        if pod is not None:
            sizes = {"pod": pod, **sizes}
        if math.prod(sizes.values()) != world:
            raise ValueError(
                f"a {tuple(sizes.values())} mesh needs "
                f"{math.prod(sizes.values())} ranks, the process group has "
                f"{world}")
        self.axis_sizes = sizes
        self.coords = self.coords_of(dist.get_rank(self.group))
        self._groups: dict[tuple[str, ...], object] = {}
        self._check_backend(world)
        live = self._live(tuple(sizes))
        if len(live) == 1:
            # the whole group is the data axis; no group is made, so a bare
            # process group and Mesh(world) run the same collectives
            self._groups[live] = self.group
            return
        # every subset of the live axes, smallest first, in the mesh's
        # order: every rank makes the same groups in the same order
        for n in range(1, len(live) + 1):
            for axes in itertools.combinations(live, n):
                self._groups[axes] = self._make(axes)

    def _live(self, axes) -> tuple[str, ...]:
        """``axes`` in the mesh's order, without a pod or model axis of
        size 1 (nothing crosses it); the data axis always stays."""
        return tuple(a for a in AXES if a in axes and a in self.axis_sizes
                     and (a == "data" or self.axis_sizes[a] > 1))

    def _check_backend(self, world: int) -> None:
        """NCCL runs one rank a card: a mesh of more ranks than cards
        raises here, rather than put two ranks on one card or deadlock."""
        backend = str(dist.get_backend(self.group))
        if "nccl" in backend and torch.cuda.device_count() < world:
            raise ValueError(
                f"a {tuple(self.axis_sizes.values())} mesh on NCCL needs "
                f"{world} cards, this host has {torch.cuda.device_count()}; "
                f"run more ranks than cards on gloo")

    def _make(self, axes: tuple[str, ...]):
        """One ``dist.new_group`` per row of ``axes`` (every rank makes
        every group, in the same order); returns this rank's."""
        names = tuple(self.axis_sizes)
        others = [a for a in names if a not in axes]
        mine = None
        for fixed in itertools.product(
                *(range(self.axis_sizes[a]) for a in others)):
            at = dict(zip(others, fixed))
            ranks = []
            for idx in itertools.product(
                    *(range(self.axis_sizes[a]) for a in axes)):
                at.update(zip(axes, idx))
                r = 0
                for a in names:
                    r = r * self.axis_sizes[a] + at[a]
                ranks.append(dist.get_global_rank(self.group, r))
            g = dist.new_group(ranks)
            if all(self.coords[a] == at[a] for a in others):
                mine = g
        return mine

    def coords_of(self, rank: int) -> dict[str, int]:
        """The mesh coordinates of group rank ``rank``."""
        out = {}
        for a in reversed(tuple(self.axis_sizes)):
            out[a] = rank % self.axis_sizes[a]
            rank //= self.axis_sizes[a]
        return {a: out[a] for a in self.axis_sizes}

    def size(self, axes) -> int:
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_sizes.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group_for(self, axes: tuple[str, ...]):
        """The process group over ``axes`` that holds this rank (None for
        no axes, or only axes of size 1 other than data)."""
        axes = self._live(axes)
        if not axes:
            return None
        return self._groups.get(axes)


def make_local_mesh(data: int = 1, model: int = 1, pod: int | None = None,
                    group=None) -> Mesh:
    """The ``(data, model)`` mesh over the default group (or ``group``), or
    ``(pod, data, model)`` with ``pod``; every rank calls it, as every rank
    builds the reference's mesh."""
    return Mesh(data, model, group, pod=pod)


def as_mesh(group_or_mesh) -> Mesh:
    """A ``Mesh`` as it is; a bare process group as ``(world, 1)``."""
    if isinstance(group_or_mesh, Mesh):
        return group_or_mesh
    return Mesh(dist.get_world_size(group_or_mesh), 1, group_or_mesh)


# Hardware constants of the cost model's builtin roofline (core.policy
# CostModel.default, core.profile.builtin_profile), per card: datasheet
# figures of the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W power limit, not
# measurements.  A card capped below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989e12  # FLOP/s: dense bf16 tensor cores (H100 SXM5, 700 W)
HBM_BW = 3.35e12          # B/s: HBM3 bandwidth (H100 SXM5, 700 W)
ICI_BW = 450e9            # B/s: NVLink 4, per direction (H100 SXM5, 700 W)
