"""Plan-to-plan resharding through the per-tensor shard index (port of
``repro/core/reshard.py``).

``GroupIndex`` is one group's ``GroupPlan`` plus its outer (TP/EP)
composition, viewed as an address map from any tensor to the ``(shard, lo,
hi)`` extents that hold it (``GroupPlan.tensor_extents``).  Two of them --
the layout data was saved under and the layout it must land in -- move a
tensor between plans without holding more than that tensor on the host:
across world sizes (``num_shards``/``shard_size``), planner modes (ragged,
fsdp2, megatron, naive), outer splits and groups (a tensor's owning group
is looked up by name on each side).

A group buffer's sharded dim is split into ``outer_size * num_shards``
uniform rows; row ``j = r*m + k`` is FSDP shard ``k`` of outer part ``r``.
Readers and writers are callables ``read(j, layer) -> 1-D row`` and
``write(j, layer) -> writable 1-D row``, so one copy loop streams through
host arrays, ``.npy`` memmaps, or one rank's own row.

Block-granular leaves (quant scales: one unit per ``div`` elements) and
integer code leaves move on the aligned path: extents rescaled to ``div``
units (exact: the planner aligns tensor starts and S to the quant block),
copied extent to extent, which needs the same outer layout on both sides;
a change that would alter block membership raises.

PARITY: BITWISE -- numpy data movement over integer extents, the
reference's code.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Mapping

import numpy as np

from .planner import plan_from_checkpoint_index
from .ragged import Extent, GroupPlan

Reader = Callable[[int, int | None], np.ndarray]
Writer = Callable[[int, int | None], np.ndarray]


@dataclasses.dataclass(frozen=True)
class GroupIndex:
    """One group's layout as an addressable per-tensor shard index."""

    plan: GroupPlan
    outer_size: int = 1
    outer_dims: Mapping[str, int] = dataclasses.field(default_factory=dict)
    n_layers: int = 0

    def __post_init__(self):
        # outer_size 1 means no effective split: normalize so layouts that
        # differ only in vestigial outer metadata compare equal.
        dims = dict(self.outer_dims) if self.outer_size > 1 else {}
        object.__setattr__(self, "outer_dims", dims)

    # ---- constructors ----------------------------------------------------
    @classmethod
    def from_layout(cls, lo) -> "GroupIndex":
        """From a live ``GroupLayout`` (core.fsdp)."""
        return cls(plan=lo.plan, outer_size=lo.outer_size,
                   outer_dims={n: sd.dim for n, sd in lo.gdef.outer.items()},
                   n_layers=lo.n_layers or 0)

    @classmethod
    def from_entry(cls, entry) -> "GroupIndex":
        """From a ``GroupPlanEntry`` (core.policy) -- no runtime needed."""
        return cls(plan=entry.plan, outer_size=entry.outer_size,
                   outer_dims=dict(entry.outer_dims),
                   n_layers=entry.n_layers or 0)

    @classmethod
    def from_meta(cls, saved: Mapping) -> "GroupIndex":
        """From one group's checkpoint ``meta.json`` entry (any version)."""
        plan = plan_from_checkpoint_index(
            saved["index"], saved["shard_size"], saved["num_shards"],
            mode=saved.get("mode", "ragged"))
        return cls(plan=plan, outer_size=int(saved.get("outer_size", 1)),
                   outer_dims={k: int(v)
                               for k, v in saved.get("outer_dims", {}).items()},
                   n_layers=int(saved.get("n_layers") or 0))

    # ---- addressing ------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return self.plan.num_shards

    @property
    def num_rows(self) -> int:
        """Uniform rows in the sharded dim: outer parts x FSDP shards."""
        return self.outer_size * self.plan.num_shards

    def row(self, part: int, shard: int) -> int:
        return part * self.plan.num_shards + shard

    def extents(self, name: str, div: int = 1) -> tuple[Extent, ...]:
        exts = self.plan.tensor_extents(name)
        if div == 1:
            return exts
        return tuple(e.scaled(div) for e in exts)

    def local_shape(self, name: str) -> tuple[int, ...]:
        """Part-local tensor shape (the shape the planner packed)."""
        return self.plan.placement(name).spec.shape

    def full_shape(self, name: str) -> tuple[int, ...]:
        """Logical (outer-unsplit) tensor shape."""
        shape = list(self.local_shape(name))
        d = self.outer_dims.get(name)
        if d is not None:
            shape[d] *= self.outer_size
        return tuple(shape)

    def same_outer(self, other: "GroupIndex", name: str) -> bool:
        return (self.outer_size == other.outer_size
                and self.outer_dims.get(name) == other.outer_dims.get(name))

    # ---- tensor assembly / scatter ---------------------------------------
    def _read_part(self, name: str, part: int, read: Reader,
                   layer: int | None, div: int = 1) -> np.ndarray:
        size = -(-self.plan.placement(name).spec.size // div)
        flat = None
        for e in self.extents(name, div):
            row = np.asarray(read(self.row(part, e.shard), layer))
            if flat is None:
                flat = np.empty(size, dtype=row.dtype)
            flat[e.tensor_lo: e.tensor_lo + e.size] = row[e.lo: e.hi]
        return flat

    def _write_part(self, name: str, part: int, flat: np.ndarray,
                    write: Writer, layer: int | None, div: int = 1) -> None:
        for e in self.extents(name, div):
            row = write(self.row(part, e.shard), layer)
            row[e.lo: e.hi] = flat[e.tensor_lo: e.tensor_lo + e.size]

    def read_tensor(self, name: str, read: Reader,
                    layer: int | None = None) -> np.ndarray:
        """Assemble the full logical tensor from its extents.

        Outer-split tensors concatenate all parts along their split dim;
        replicated tensors (no entry in ``outer_dims``) read part 0.
        """
        d = self.outer_dims.get(name)
        if d is None:
            return self._read_part(name, 0, read, layer).reshape(
                self.local_shape(name))
        parts = [
            self._read_part(name, r, read, layer).reshape(
                self.local_shape(name))
            for r in range(self.outer_size)
        ]
        return np.concatenate(parts, axis=d)

    def write_tensor(self, name: str, full: np.ndarray, write: Writer,
                     layer: int | None = None) -> None:
        """Scatter the full logical tensor into its extents.

        Outer-split tensors are split along their dim; tensors replicated
        over the outer axis are written into every part.
        """
        d = self.outer_dims.get(name)
        if d is None:
            parts = [full] * self.outer_size
        else:
            parts = np.split(full, self.outer_size, axis=d)
        for r, part in enumerate(parts):
            self._write_part(name, r, np.ascontiguousarray(part).reshape(-1),
                             write, layer)


def _part_offsets(idx: GroupIndex, name: str) -> list[int] | None:
    """Where each outer part of ``name`` starts in the logical tensor's
    flat order: 0 for every part where the tensor is not split (each part
    holds all of it), ``r * part size`` where it is split on a dim with
    only size-1 dims before it (each part is one contiguous range of the
    tensor); None where the parts interleave."""
    d = idx.outer_dims.get(name)
    if d is None:
        return [0] * idx.outer_size
    shape = idx.local_shape(name)
    if math.prod(shape[:d]) != 1:
        return None
    return [r * math.prod(shape) for r in range(idx.outer_size)]


def _pieces(idx: GroupIndex, name: str, parts: Iterable[tuple[int, int]],
            div: int) -> list[tuple[int, int, int, int]]:
    """``(lo, hi, row, row_lo)``: each extent of ``name`` in each ``(part,
    offset)`` of ``parts``, as the range it covers in an order the two
    sides of a copy share."""
    exts = idx.extents(name, div)
    return [(off + e.tensor_lo, off + e.tensor_lo + e.size,
             idx.row(r, e.shard), e.lo) for r, off in parts for e in exts]


def _copy_pieces(src, dst, read: Reader, write: Writer,
                 layer: int | None) -> None:
    """Copy every overlap of a source piece with a destination piece, row
    to row: one copy of each element, no tensor assembled."""
    for lo, hi, j, at in dst:
        out = None
        for s_lo, s_hi, s_j, s_at in src:
            a, b = max(lo, s_lo), min(hi, s_hi)
            if a >= b:
                continue
            if out is None:
                out = write(j, layer)
            out[at + a - lo: at + b - lo] = \
                read(s_j, layer)[s_at + a - s_lo: s_at + b - s_lo]


def copy_tensor(src: GroupIndex, dst: GroupIndex, name: str,
                read: Reader, write: Writer, *, layer: int | None = None,
                div: int = 1, aligned: bool = False) -> None:
    """Move one tensor's data from layout ``src`` to layout ``dst``.

    ``div`` > 1 copies block-granular units (e.g. quant scales: one unit per
    ``div`` elements).  ``aligned`` forces the extent-to-extent path, required
    for leaves whose values depend on position (int8 codes, scales): both
    layouts must then agree on the outer split of ``name``, else this raises
    rather than silently reinterpreting blocks.

    Extents are copied row to row wherever each outer part maps onto a
    range of the other side's: the same outer split (part to part), or
    parts that are contiguous ranges of the logical tensor (a split on its
    leading dim, or none: a replicated tensor is read from part 0).  Only
    parts that interleave (a split on a later dim, across a change of the
    split) assemble the tensor and split it anew.
    """
    if src.same_outer(dst, name):
        for r in range(src.outer_size):
            _copy_pieces(_pieces(src, name, [(r, 0)], div),
                         _pieces(dst, name, [(r, 0)], div), read, write,
                         layer)
        return
    if aligned or div != 1:
        raise ValueError(
            f"{name}: outer layout changed (src outer_size={src.outer_size} "
            f"dim={src.outer_dims.get(name)}, dst outer_size={dst.outer_size} "
            f"dim={dst.outer_dims.get(name)}); block-granular state cannot be "
            f"remapped across an outer (TP/EP) change -- rebuild it from the "
            f"master instead")
    want = dst.full_shape(name)
    if src.full_shape(name) != want:
        raise ValueError(
            f"{name}: logical shape changed across plans "
            f"({src.full_shape(name)} -> {want}); cannot reshard")
    s_off, d_off = _part_offsets(src, name), _part_offsets(dst, name)
    if s_off is not None and d_off is not None:
        # a tensor no part splits is read from part 0 alone
        s_parts = list(enumerate(s_off))
        if name not in src.outer_dims:
            s_parts = s_parts[:1]
        _copy_pieces(_pieces(src, name, s_parts, 1),
                     _pieces(dst, name, enumerate(d_off), 1), read, write,
                     layer)
        return
    dst.write_tensor(name, src.read_tensor(name, read, layer), write, layer)


def stream_tensors(dst: GroupIndex, write: Writer,
                   src_lookup: Callable[[str], tuple[GroupIndex, Reader]],
                   names: Iterable[str] | None = None) -> None:
    """Stream every tensor of ``dst``'s plan from its source layout.

    ``src_lookup(name)`` returns the source ``(GroupIndex, Reader)`` owning
    that tensor (sources may live in different groups than the destination).
    Peak host memory is one tensor: each is assembled, scattered, dropped.
    """
    for name in (dst.plan.names if names is None else names):
        s_idx, s_read = src_lookup(name)
        if (s_idx.n_layers or 0) != (dst.n_layers or 0):
            raise ValueError(
                f"{name}: layer count changed across plans "
                f"({s_idx.n_layers} -> {dst.n_layers}); cannot reshard")
        for li in (range(dst.n_layers) if dst.n_layers else [None]):
            copy_tensor(s_idx, dst, name, s_read, write, layer=li)


# ---------------------------------------------------------------------------
# host-array readers and writers (the file-backed ones live with their
# formats in checkpoint/ckpt.py and tools/reshard.py)
# ---------------------------------------------------------------------------

def buffer_reader(arr: np.ndarray, num_rows: int) -> Reader:
    """Read rows of a full host buffer shaped ``(L, num_rows*Sleaf)`` or
    ``(num_rows*Sleaf,)``."""
    s = arr.shape[-1] // num_rows

    def read(j: int, layer: int | None) -> np.ndarray:
        row = arr if layer is None else arr[layer]
        return row[j * s: (j + 1) * s]

    return read


def buffer_writer(arr: np.ndarray, num_rows: int) -> Writer:
    """Write rows of a full host buffer (same shapes as ``buffer_reader``)."""
    s = arr.shape[-1] // num_rows

    def write(j: int, layer: int | None) -> np.ndarray:
        row = arr if layer is None else arr[layer]
        return row[j * s: (j + 1) * s]

    return write


def row_writer(local: np.ndarray, own: int) -> Writer:
    """Write only row ``own`` of a buffer, held as ``local`` (one rank's
    ``(L, Sleaf)`` or ``(Sleaf,)`` share); the other rows' extents land in
    a scratch row and are dropped.  Every rank streams the whole tensor and
    keeps its own part."""
    scratch = np.empty(local.shape[-1], local.dtype)

    def write(j: int, layer: int | None) -> np.ndarray:
        if j != own:
            return scratch
        return local if layer is None else local[layer]

    return write
