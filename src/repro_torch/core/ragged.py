"""RaggedShard: the paper's flexible sharding format, as host-side metadata
(port of ``repro/core/ragged.py``).

A RaggedShard placement of a tensor ``t`` is described by

  * a *sharding granularity* ``g_t``: the size (in contiguous elements,
    row-major) of the atomic non-shardable block, and
  * a *distribution*: which contiguous interval ``[l_t, r_t)`` of a global
    communication buffer the tensor occupies.  Rank ``k`` of ``m`` owns the
    buffer interval ``[k*S, (k+1)*S)``, so a tensor may contribute
    different numbers of blocks to different ranks.

Pure Python integer work: planned layouts are BITWISE the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

# Alignment unit of the flat buffers (elements).  The reference takes the
# TPU lane width; the port keeps 128 so that plans -- and with them the
# packed buffers and checkpoints -- stay identical across the two packages.
# 128 fp32 elements are 512 bytes, a multiple of NCCL's and the 16-byte
# vector loads' alignment.
LANE = 128


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A logical tensor to be ragged-sharded; ``granularity`` is g_t."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    granularity: int = 1

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        if self.granularity < 1:
            raise ValueError(f"{self.name}: granularity must be >= 1")
        if self.size % self.granularity != 0:
            raise ValueError(
                f"{self.name}: size {self.size} not divisible by granularity "
                f"{self.granularity}"
            )

    @property
    def size(self) -> int:
        return _prod(self.shape)

    @property
    def num_blocks(self) -> int:
        return self.size // self.granularity

    def row_size(self) -> int:
        return _prod(self.shape[1:]) if len(self.shape) > 1 else 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Tensor ``spec`` lives at ``[offset, offset+spec.size)`` in the
    group's global buffer."""

    spec: TensorSpec
    offset: int

    @property
    def end(self) -> int:
        return self.offset + self.spec.size


@dataclasses.dataclass(frozen=True)
class LocalPiece:
    """The part of one tensor owned by one rank: ``buf_lo:buf_hi`` index
    the rank's local shard, ``tensor_lo`` is where the piece begins inside
    the flat tensor (whole blocks only)."""

    name: str
    buf_lo: int
    buf_hi: int
    tensor_lo: int
    granularity: int

    @property
    def size(self) -> int:
        return self.buf_hi - self.buf_lo


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Output of the planner for one communication group.

    The global buffer has ``num_shards * shard_size`` elements; rank k owns
    ``[k*S, (k+1)*S)``.  ``placements`` are in buffer order and pairwise
    disjoint; gaps are padding (between tensors only, never inside one).
    """

    placements: tuple[Placement, ...]
    shard_size: int
    num_shards: int
    mode: str = "ragged"

    @property
    def total(self) -> int:
        return self.shard_size * self.num_shards

    @property
    def payload(self) -> int:
        return sum(p.spec.size for p in self.placements)

    @property
    def padding(self) -> int:
        return self.total - self.payload

    @property
    def padding_ratio(self) -> float:
        return self.padding / max(self.payload, 1)

    def __post_init__(self):
        object.__setattr__(self, "placements", tuple(self.placements))

    def placement(self, name: str) -> Placement:
        for p in self.placements:
            if p.spec.name == name:
                return p
        raise KeyError(name)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(p.spec.name for p in self.placements)

    def validate(self) -> None:
        """The paper's three constraints: no overlap, inside the buffer,
        and no shard boundary splitting a block."""
        S, m = self.shard_size, self.num_shards
        prev_end = 0
        for p in sorted(self.placements, key=lambda p: p.offset):
            if p.offset < prev_end:
                raise ValueError(f"{p.spec.name}: overlaps previous tensor")
            prev_end = p.end
            if p.end > m * S:
                raise ValueError(f"{p.spec.name}: exceeds global buffer")
            if self.mode != "ragged":
                continue
            g = p.spec.granularity
            for k in range(p.offset // S + 1, (p.end - 1) // S + 1):
                if (k * S - p.offset) % g != 0:
                    raise ValueError(
                        f"{p.spec.name}: shard boundary {k}*{S} splits a "
                        f"block (granularity {g})"
                    )

    def local_layout(self, device: int) -> tuple[LocalPiece, ...]:
        """Which (whole-block) pieces of which tensors live on ``device``."""
        S = self.shard_size
        lo, hi = device * S, (device + 1) * S
        pieces = []
        for p in self.placements:
            a, b = max(p.offset, lo), min(p.end, hi)
            if a >= b:
                continue
            pieces.append(LocalPiece(name=p.spec.name, buf_lo=a - lo,
                                     buf_hi=b - lo, tensor_lo=a - p.offset,
                                     granularity=p.spec.granularity))
        return tuple(pieces)


@dataclasses.dataclass(frozen=True)
class ShardDim:
    """An (outer) even sharding along one tensor dim over a mesh axis --
    the TP/EP placements RaggedShard composes with."""

    dim: int
    axis: str


def compose_granularity(spec: TensorSpec, outer: ShardDim | None,
                        axis_size: int) -> TensorSpec:
    """Adapt a TensorSpec for FSDP packing after an outer Shard(dim): the
    planner packs the TP/EP-local tensor, and for Shard(dim>0) the ragged
    granularity becomes LCM(user granularity, stride of dim)."""
    if outer is None:
        return spec
    shape = list(spec.shape)
    if shape[outer.dim] % axis_size != 0:
        raise ValueError(
            f"{spec.name}: dim {outer.dim} (={shape[outer.dim]}) not divisible "
            f"by axis size {axis_size}"
        )
    shape[outer.dim] //= axis_size
    g = spec.granularity
    if outer.dim > 0:
        stride = _prod(shape[outer.dim:])
        g = math.lcm(g, stride)
        g = min(g, _prod(shape))
        if _prod(shape) % g:
            g = stride
    return TensorSpec(spec.name, tuple(shape), spec.dtype, g)


def checkpoint_index(plan: GroupPlan) -> dict:
    """A DCP-style index of a plan: name -> (shape, dtype, granularity,
    offset); ``planner.plan_from_checkpoint_index`` reads it back."""
    return {
        p.spec.name: dict(shape=list(p.spec.shape), dtype=p.spec.dtype,
                          granularity=p.spec.granularity, offset=p.offset)
        for p in plan.placements
    }
