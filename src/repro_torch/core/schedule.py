"""CommSchedule: the FSDP runtime's communication schedule (port of
``repro/core/schedule.py``).

The port runs the reference's default schedule: per-layer all-gathers
inside the checkpointed layer body (backward re-gathers = ZeRO-3), a cast
wire in the compute dtype (or ``gather_dtype``) and a cast gradient
reduce-scatter that accumulates in ``reduce_dtype``, falling back to the
wire dtype.  With bf16 compute the gradients therefore cross a bf16
reduce-scatter and are cast to fp32 after it, on one rank as on many.

It also runs block-wise quantized training:

  * ``param_store="q8_block"`` -- the group's state holds int8 codes and
    per-block fp32 scales beside the fp32 master; the all-gather moves the
    codes and scales and decodes them into the compute dtype.
  * ``reduce_wire`` -- the gradient reduce-scatter's wire format: ``None``
    (the legacy ``reduce_dtype`` rule), a cast name (``"fp32"``,
    ``"bf16"``), or ``"q8_block"``, the quantized gradient wire: each rank
    encodes its cotangent plus an error-feedback residual as int8 codes and
    per-block scales, and destinations dequantize and sum in fp32.

It serves, too: ``serve_quant_matmul=True`` (with
``param_store="q8_block"`` only: ``validate_for`` raises the reference's
``ValueError`` otherwise)
keeps eligible gathered layer weights in int8 through the serve steps'
matmuls (``ops.q8_matmul``); the train step ignores it.

Knobs the reference has and the port does not run yet raise
``NotImplementedError`` at construction, naming the ROADMAP item that will
port them: ``prefetch``, ``keep_last_gathered``,
``reshard_after_forward=False``, ``gather_mode="ring"``,
``reduce_mode="ring_acc"``, ``ring_chunk_elems``, ``sharded=False``, fp8
wire dtypes and the bf16 and fp8 stores.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from .wire import (CAST_FORMATS, STORE_FORMATS, WireCodec, check_wire_format,
                   fmt_of_dtype)

_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
}
# dtype names the reference accepts where its JAX provides float8
_FP8_NAMES = ("fp8_e4m3", "fp8_e5m2")

_GATHER_MODES = ("xla", "ring")
_REDUCE_MODES = ("match", "ring_acc")

GROUP_OVERRIDE_KEYS = frozenset(
    {"gather_mode", "gather_dtype", "reduce_dtype", "sharded",
     "reduce_mode", "param_store", "reduce_wire", "ring_chunk_elems"})


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item})")


def _check_name(name: str | None) -> None:
    if name is None:
        return
    if name in _FP8_NAMES:
        raise _not_ported(f"the {name} wire dtype", "Queue 1 item 9")
    if name not in _DTYPES:
        raise ValueError(
            f"unknown schedule dtype {name!r}; expected one of "
            f"{sorted(_DTYPES) + list(_FP8_NAMES)}")


def _resolve(name: str | None, default: torch.dtype) -> torch.dtype:
    if name is None:
        return default
    _check_name(name)
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Resolved layer-scan structure for one ``n_layers`` stack (the
    reference's small-n fallbacks made explicit)."""

    n_layers: int
    main: int
    split_last: bool
    prefetch: bool
    pairs: int
    tail: int


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    prefetch: bool = False
    reshard_after_forward: bool = True
    keep_last_gathered: bool = False
    gather_dtype: str | None = None
    reduce_dtype: str | None = None
    gather_mode: str = "xla"
    reduce_mode: str = "match"
    param_store: str = "fp32"
    reduce_wire: str | None = None
    sharded: bool = True
    ring_chunk_elems: int | None = None
    serve_quant_matmul: bool = False

    def __post_init__(self):
        _check_name(self.gather_dtype)
        _check_name(self.reduce_dtype)
        check_wire_format(self.reduce_wire, "reduce_wire")
        if self.reduce_wire is not None and self.reduce_dtype is not None:
            raise ValueError(
                f"pass either reduce_wire ({self.reduce_wire!r}) or the "
                f"legacy reduce_dtype ({self.reduce_dtype!r}), not both: "
                f"reduce_dtype lowers onto a cast reduce_wire")
        if self.gather_mode not in _GATHER_MODES:
            raise ValueError(
                f"unknown gather_mode {self.gather_mode!r}; expected one of "
                f"{list(_GATHER_MODES)}")
        if self.reduce_mode not in _REDUCE_MODES:
            raise ValueError(
                f"unknown reduce_mode {self.reduce_mode!r}; expected one of "
                f"{list(_REDUCE_MODES)}")
        if self.param_store not in STORE_FORMATS:
            raise ValueError(
                f"unknown param_store {self.param_store!r}; expected one of "
                f"{list(STORE_FORMATS)}")
        unported = (
            (self.prefetch, "prefetch", "Queue 1 item 10"),
            (self.keep_last_gathered, "keep_last_gathered",
             "Queue 1 item 10"),
            (not self.reshard_after_forward, "reshard_after_forward=False",
             "Queue 1 item 10"),
            (self.gather_mode == "ring", "gather_mode='ring'",
             "Queue 1 item 10"),
            (self.reduce_mode == "ring_acc", "reduce_mode='ring_acc'",
             "Queue 1 item 10"),
            (self.ring_chunk_elems is not None, "ring_chunk_elems",
             "Queue 1 item 10"),
            (not self.sharded, "sharded=False (replicated groups)",
             "Queue 1 item 10"),
            (self.param_store not in ("fp32", "q8_block"),
             f"param_store={self.param_store!r}", "Queue 1 item 9"),
        )
        for hit, what, item in unported:
            if hit:
                raise _not_ported(what, item)

    @classmethod
    def from_parallel(cls, par) -> "CommSchedule":
        return cls(
            prefetch=par.prefetch,
            reshard_after_forward=par.reshard_after_forward,
            keep_last_gathered=par.keep_last_gathered,
            gather_dtype=par.gather_dtype,
            reduce_dtype=par.reduce_dtype,
            gather_mode=par.gather_mode,
            reduce_mode=par.reduce_mode,
            param_store=par.param_store,
            reduce_wire=par.reduce_wire,
        )

    def wire_dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        return _resolve(self.gather_dtype, compute_dtype)

    def accum_dtype(self, compute_dtype: torch.dtype) -> torch.dtype:
        """Accumulate dtype of the gradient reduce-scatter: fp32 for the q8
        reduce wire (destinations sum dequantized contributions in fp32),
        the named dtype for a cast reduce wire, else ``reduce_dtype`` when
        set and the gather wire dtype otherwise (the reference's rule)."""
        if self.reduce_wire == "q8_block":
            return torch.float32
        if self.reduce_wire is not None:
            return CAST_FORMATS[self.reduce_wire]
        return _resolve(self.reduce_dtype, self.wire_dtype(compute_dtype))

    def gather_codec(self, compute_dtype: torch.dtype) -> WireCodec:
        """Cast codec of the all-gather of a flat store (a quantized store
        gathers its stored codes and scales instead)."""
        return WireCodec(fmt_of_dtype(self.wire_dtype(compute_dtype)))

    def reduce_codec(self, compute_dtype: torch.dtype,
                     block: int = 1024) -> WireCodec:
        """The gradient reduce-scatter's codec: ``reduce_wire`` when set
        (``block`` is the group's quant block), else a cast codec of the
        accum dtype."""
        if self.reduce_wire is not None:
            return WireCodec(self.reduce_wire, block)
        return WireCodec(fmt_of_dtype(self.accum_dtype(compute_dtype)))

    @property
    def ef_enabled(self) -> bool:
        """The q8 reduce wire always runs error feedback: the residual
        state exists iff the reduce codec is lossy."""
        return self.reduce_wire == "q8_block"

    def validate_for(self, compute_dtype: torch.dtype) -> None:
        """Resolve the wire/accum dtype path against the actual compute
        dtype: a ``None`` dtype inherits it, so e.g. fp16 compute fails at
        runtime construction.  Also the reference's q8 rules: a quantized
        store fixes the gather payload, and ``serve_quant_matmul`` needs
        the q8_block store.  (Its rule that the q8 reduce wire
        needs a sharded group comes with ``sharded=False``, Queue 1 item
        10.)"""
        supported = set(_DTYPES.values())
        for role, dt in (("gather", self.wire_dtype(compute_dtype)),
                         ("reduce", self.accum_dtype(compute_dtype))):
            if dt not in supported:
                raise ValueError(
                    f"schedule {role} dtype resolves to unsupported {dt} "
                    f"(compute dtype {compute_dtype}); supported: "
                    f"{sorted(set(_DTYPES))}")
        if self.param_store == "q8_block" and self.gather_dtype is not None:
            raise ValueError(
                "param_store='q8_block' fixes the all-gather payload (int8 "
                "codes + fp32 scales); gather_dtype must stay None, got "
                f"{self.gather_dtype!r}")
        if self.serve_quant_matmul and self.param_store != "q8_block":
            raise ValueError(
                "serve_quant_matmul runs the int8 GEMM on gathered q8_block "
                "codes; it requires param_store='q8_block', got "
                f"{self.param_store!r}")

    def plan_layers(self, n_layers: int, remat: bool = True) -> LayerPlan:
        n = int(n_layers)
        split_last = bool(self.keep_last_gathered and remat
                          and self.reshard_after_forward and n >= 1)
        main = n - 1 if split_last else n
        prefetch = bool(self.prefetch and main >= 2)
        pairs = main // 2 if prefetch else 0
        tail = main - 2 * pairs if prefetch else 0
        return LayerPlan(n_layers=n, main=main, split_last=split_last,
                         prefetch=prefetch, pairs=pairs, tail=tail)


def resolve_group_schedules(base: CommSchedule, overrides) -> dict:
    """Apply per-group override dicts to ``base`` (keys drawn from
    ``GROUP_OVERRIDE_KEYS``)."""
    out: dict[str, CommSchedule] = {}
    for name, ov in (overrides or {}).items():
        if not isinstance(ov, Mapping):
            raise ValueError(
                f"group_schedules[{name!r}] must be a dict over "
                f"{sorted(GROUP_OVERRIDE_KEYS)}, got {type(ov).__name__}")
        bad = set(ov) - GROUP_OVERRIDE_KEYS
        if bad:
            raise ValueError(
                f"group_schedules[{name!r}]: unknown override keys "
                f"{sorted(bad)}; allowed: {sorted(GROUP_OVERRIDE_KEYS)}")
        ov = dict(ov)
        if "reduce_wire" in ov and "reduce_dtype" not in ov:
            ov["reduce_dtype"] = None
        elif "reduce_dtype" in ov and "reduce_wire" not in ov:
            ov["reduce_wire"] = None
        out[name] = dataclasses.replace(base, **ov)
    return out
