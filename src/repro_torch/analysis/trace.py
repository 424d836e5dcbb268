"""One train step traced on meta tensors: ``CommTrace`` and ``BufferTrace``
(the counterpart of ``repro/analysis/jaxpr.py``).

The reference walks the closed jaxpr of an abstract-eval'd step.  The
port has no program to walk: it runs one train step of rank 0 on meta
tensors (shapes and dtypes, no values, no memory) over a process group of
the ``"fake"`` backend (``launch.mesh.fake_world``), under the dry run's
dispatch mode (``launch.dryrun.StepRecorder``), and keeps:

  * ``CommTrace`` -- every c10d collective as a ``CollectiveEvent`` in the
    reference's vocabulary (``all_gather``, ``psum_scatter``, ``ppermute``
    for each ``batch_isend_irecv`` send of a ring hop, ``psum``,
    ``all_to_all``) with the mesh axes its process group spans, the
    group's size, the payload's dtype (float8 codes, which the wire moves
    as uint8 views, under their own name) and per-rank elements.  An
    eager step records every execution, so ``trips`` is 1.  ``path`` is
    the trail of the port's functions that issued it.
  * ``BufferTrace`` -- the peak count of simultaneously live storages of
    each ``(elements, dtype)`` class the step allocated (its inputs
    excluded), each int8 or float8 -> float32 conversion outside a kernel
    (``kernels.ops``' calls are opaque on meta, as Pallas bodies are to the
    reference's walker), and the step's output tree as shapes (for
    ``ef_threading``).

Two departures, both decisions of the port:

  * No scan carries.  The reference's ``gathered_peak`` has two teeth: no
    gathered buffer in a scan carry, and a liveness bound.  An eager step
    has no carry; a gathered buffer held for backward simply stays live,
    which the liveness count sees.  ``scan_carries`` is empty and the
    reference's bound, ``2 x slots + 1``, is kept.
  * A runtime on a real process group (the card's NCCL group, a gloo
    group) is never traced itself.  ``trace_train_step`` builds a meta
    twin from its config, plan, compute dtype and optimizer class on a
    fake group of the same mesh, in this process when it has no default
    group (or a fake one of that size), else in a child process with no
    card visible.  Verifying launches nothing and allocates nothing on
    the card.

PARITY: a class of its own.  The events carry the reference's fields and
``wire_bytes`` is the reference's formula; which events exist follows the
port's wire (``core.wire``), whose routes are the reference's.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Any, Mapping

import torch
from torch.utils._pytree import tree_map

from ..core.policy import dtype_name


# --------------------------------------------------------------------------- #
# CommTrace
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective of the traced step.  ``wire_bytes`` is the bytes one
    execution puts on the wire per rank: an all_gather ships its m-1
    remote shards, a psum_scatter (m-1)/m of its input, a ppermute hop its
    whole operand, a psum a reduce and a broadcast (2(m-1)/m), an
    all_to_all (m-1)/m of its input -- the reference's formula."""

    kind: str
    axes: tuple[str, ...]
    axis_size: int
    dtype: str
    elems: int
    trips: int
    path: str

    @property
    def itemsize(self) -> int:
        return getattr(torch, self.dtype).itemsize

    @property
    def in_bytes(self) -> int:
        return self.elems * self.itemsize

    @property
    def wire_bytes(self) -> float:
        m = self.axis_size
        if m <= 1:
            return 0.0
        if self.kind == "all_gather":
            return float(self.in_bytes * (m - 1))
        if self.kind in ("psum_scatter", "reduce_scatter"):
            return float(self.in_bytes) * (m - 1) / m
        if self.kind == "ppermute":
            return float(self.in_bytes)
        if self.kind == "psum":
            return 2.0 * self.in_bytes * (m - 1) / m
        if self.kind == "all_to_all":
            return float(self.in_bytes) * (m - 1) / m
        return 0.0


@dataclasses.dataclass(frozen=True)
class CommTrace:
    """All collective events of one traced step."""

    events: tuple[CollectiveEvent, ...]
    axis_sizes: dict[str, int]


# --------------------------------------------------------------------------- #
# BufferTrace
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Conversion:
    """An int8 or float8 -> float32 conversion outside a kernel."""

    src_dtype: str
    elems: int
    path: str


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A tensor of the step's output, as its shape and dtype name."""

    shape: tuple[int, ...]
    dtype: str


def leaf_specs(tree):
    """``tree`` with each tensor replaced by its ``LeafSpec``."""
    return tree_map(lambda t: LeafSpec(tuple(t.shape), dtype_name(t.dtype))
                    if isinstance(t, torch.Tensor) else t, tree)


@dataclasses.dataclass(frozen=True)
class BufferTrace:
    """The storage view of one traced step: per ``(elements, dtype)``
    class the peak count of live storages, the int8/float8 -> float32
    conversions outside kernels, and no scan carries (the module
    docstring)."""

    class_peaks: Mapping[tuple[int, str], int]
    conversions: tuple[Conversion, ...]
    scan_carries: tuple = ()

    def live_peak(self, *, elems: int, dtype) -> int:
        """The most storages of exactly ``elems`` elements of ``dtype``
        live at once during the step."""
        return int(self.class_peaks.get((int(elems), dtype_name(dtype)), 0))

    def full_f32(self, n: int, src_dtype: str | None = None
                 ) -> list[Conversion]:
        """The conversions to float32 of at least ``n`` elements (from
        ``src_dtype`` only, when given)."""
        return [c for c in self.conversions if c.elems >= n
                and (src_dtype is None or c.src_dtype == src_dtype)]


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """What ``trace_train_step`` returns: the comm and buffer traces, the
    step's output as ``LeafSpec``s, the mesh's axis sizes and the seconds
    the trace took."""

    comm: CommTrace
    buffers: BufferTrace
    out_shapes: Any
    axis_sizes: dict[str, int]
    seconds: float


def from_record(record, axis_sizes: Mapping[str, int]) -> StepTrace:
    """The traces of a dry run's ``StepRecord`` (``launch.dryrun``)."""
    return StepTrace(
        comm=CommTrace(tuple(record.events), dict(axis_sizes)),
        buffers=BufferTrace(
            dict(record.class_peaks),
            tuple(Conversion(*c) for c in record.conversions)),
        out_shapes=record.out_shapes, axis_sizes=dict(axis_sizes),
        seconds=record.seconds)


# --------------------------------------------------------------------------- #
# step tracing
# --------------------------------------------------------------------------- #
def _batch_shapes(batch) -> dict | None:
    if batch is None:
        return None
    return {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}


def _trace(cfg, plan_json: dict, axis_sizes, compute_dtype: str, seq: int,
           batch_size: int, optimizer_cls, batch, model=None) -> StepTrace:
    from ..configs.base import ShapeConfig
    from ..core.policy import ShardingPlan
    from ..launch.dryrun import dry_step

    plan = ShardingPlan.from_json(plan_json)
    shape = ShapeConfig("verify", seq, batch_size, "train")
    if batch is not None:
        b, t = next(iter(batch.values()))[0][:2]
        shape = ShapeConfig("verify", t, b, "train")
    record, _ = dry_step(cfg, shape, axis_sizes, plan=plan,
                         compute_dtype=getattr(torch, compute_dtype),
                         model=model, optimizer_cls=optimizer_cls,
                         batch=batch)
    return from_record(record, axis_sizes)


def _in_child(payload: dict) -> StepTrace:
    """``_trace`` in a child process with no card visible: this process
    holds a real default group, and a dry run makes a fake one."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory(prefix="repro_torch_trace_") as tmp:
        src_p, dst_p = Path(tmp, "in.pkl"), Path(tmp, "out.pkl")
        src_p.write_bytes(pickle.dumps(payload))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.trace",
             str(src_p), str(dst_p)], env=env, capture_output=True,
            text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"the step trace's child exited {proc.returncode}: "
                f"{proc.stderr[-3000:]}")
        return pickle.loads(dst_p.read_bytes())


def trace_plan(cfg, plan, *, optimizer_cls=None, batch=None,
               batch_size: int = 4, seq: int = 16, model=None
               ) -> StepTrace:
    """One train step of a meta runtime of ``cfg`` (``model``, default
    ``build_model(cfg)``) under ``plan`` (on its mesh's axis sizes and
    compute dtype) over a fake process group: in
    this process when it has no default group (or a fake one of the
    mesh's size), else in a child process that sees no card.  The step
    runs ``optimizer_cls(cfg)`` (default: the config's optimizer) on a
    batch of ``batch``'s shapes (``{key: (global shape, dtype)}``) or of
    ``batch_size`` rows of ``seq`` tokens."""
    import torch.distributed as dist

    from ..optim import OPTIMIZERS

    axis_sizes = {a: int(n) for a, n in plan.axis_sizes.items()}
    payload = dict(cfg=cfg, plan_json=plan.to_json(), axis_sizes=axis_sizes,
                   compute_dtype=plan.compute_dtype,
                   seq=seq, batch_size=batch_size,
                   optimizer_cls=optimizer_cls or OPTIMIZERS[cfg.optimizer],
                   batch=batch)
    world = 1
    for n in axis_sizes.values():
        world *= n
    if not dist.is_initialized() or (
            "fake" in str(dist.get_backend())
            and dist.get_world_size() == world):
        return _trace(**payload, model=model)
    return _in_child(payload)


def trace_train_step(runtime, optimizer=None, *, batch=None,
                     batch_size: int = 4, seq: int = 16) -> StepTrace:
    """One train step of ``runtime``'s plan traced on a meta twin
    (``trace_plan``; the module docstring): the same config, plan,
    compute dtype, model and mesh, ``type(optimizer)`` (default: the
    config's optimizer), on a batch of the shapes of ``batch`` (a global
    batch of tensors) or of ``batch_size`` rows of ``seq`` tokens, as the
    reference's default."""
    return trace_plan(
        runtime.cfg, runtime.plan,
        optimizer_cls=None if optimizer is None else type(optimizer),
        batch=_batch_shapes(batch), batch_size=batch_size, seq=seq,
        model=runtime.model)


def _child_main(argv) -> None:
    src, dst = argv[:2]
    out = _trace(**pickle.loads(Path(src).read_bytes()))
    Path(dst).write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    # run as the package's module, so the pickled trace names its classes
    # by their import path, not ``__main__``
    from repro_torch.analysis import trace as _module

    _module._child_main(sys.argv[1:])
