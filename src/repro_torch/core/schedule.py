"""CommSchedule: the FSDP runtime's communication schedule (port of
``repro/core/schedule.py``).

The port runs the reference's default schedule: per-layer all-gathers
inside the checkpointed layer body (backward re-gathers = ZeRO-3), a cast
wire in the compute dtype (or ``gather_dtype``) and a cast gradient
reduce-scatter that accumulates in ``reduce_dtype``, falling back to the
wire dtype.  With bf16 compute the gradients therefore cross a bf16
reduce-scatter and are cast to fp32 after it, on one rank as on many.

It runs every parameter store of the reference (``param_store``):
``"fp32"``, ``"bf16"`` (the bf16 buffer is the leaf and its gradient is
bf16), ``"fp8_e4m3"``/``"fp8_e5m2"`` (fp8 codes beside the fp32 master:
the all-gather moves the codes, so ``validate_for`` refuses a
``gather_dtype`` beside them), and ``"q8_block"``.  Every dtype knob
(``gather_dtype``, ``reduce_dtype``, ``reduce_wire``) also takes the fp8
names: an fp8 cast wire, whose reduce-scatter sums the contributions as
XLA:CPU does (in float16, in rank order) and rounds to fp8 once.

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
``ValueError`` otherwise) keeps eligible gathered layer weights in int8
through the serve steps' matmuls (``ops.q8_matmul``); the train step
ignores it.

The scan structure (``plan_layers`` resolves its small-n fallbacks):

  * ``prefetch`` -- two-slot double buffering: the layer loop runs over
    layer pairs, and both slots' gathers are issued before either layer's
    compute, inside one checkpoint, so backward re-gathers the pair and at
    most two gathered layer buffers are live.
  * ``reshard_after_forward=False`` -- the gather moves outside the
    activation checkpoint: every gathered buffer is saved into backward
    (no re-gather), while activations are still recomputed.
  * ``keep_last_gathered`` -- the last layer is gathered outside its
    checkpoint, so its buffer lives into backward, where it is needed
    first.

The wire routes: ``gather_mode="ring"`` runs the all-gather as n-1
point-to-point hops (``core.wire``) and its match-mode reduce-scatter
routes chunks un-reduced to their destinations;
``reduce_mode="ring_acc"`` accumulates in flight; ``ring_chunk_elems``
bounds a ring message.  ``sharded=False`` keeps a group replicated: no
gather, its gradient all-reduced.

``VARIANTS`` and ``APPROX_VARIANTS`` are the reference's named schedules:
on one rank every ``VARIANTS`` entry trains bitwise like the default.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from .wire import (CAST_FORMATS, FP8_FORMATS, STORE_FORMATS, WireCodec,
                   check_wire_format, fmt_of_dtype)

_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "f32": torch.float32,
    "float32": torch.float32,
    **{name: CAST_FORMATS[name] for name in FP8_FORMATS},
}

_GATHER_MODES = ("xla", "ring")
_REDUCE_MODES = ("match", "ring_acc")

GROUP_OVERRIDE_KEYS = frozenset(
    {"gather_mode", "gather_dtype", "reduce_dtype", "sharded",
     "reduce_mode", "param_store", "reduce_wire", "ring_chunk_elems"})


def _check_name(name: str | None) -> None:
    if name is not None and name not in _DTYPES:
        raise ValueError(
            f"unknown schedule dtype {name!r}; expected one of "
            f"{sorted(_DTYPES)}")


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
        if self.ring_chunk_elems is not None:
            if (not isinstance(self.ring_chunk_elems, int)
                    or isinstance(self.ring_chunk_elems, bool)
                    or self.ring_chunk_elems < 1):
                raise ValueError(
                    f"ring_chunk_elems must be a positive int or None, got "
                    f"{self.ring_chunk_elems!r}")
            if (self.gather_mode != "ring" and self.reduce_mode != "ring_acc"
                    and self.reduce_wire != "q8_block"):
                raise ValueError(
                    "ring_chunk_elems only affects the manual ring routes; "
                    "this schedule has none (gather_mode='xla', "
                    "reduce_mode='match', cast reduce wire) -- drop the "
                    "knob or pick a ring mode")

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
        store fixes the gather payload, the q8 reduce wire needs a sharded
        group, and ``serve_quant_matmul`` needs the q8_block store."""
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
        if self.param_store in FP8_FORMATS and self.gather_dtype is not None:
            raise ValueError(
                f"param_store={self.param_store!r} fixes the all-gather "
                "payload (the fp8 codes themselves); gather_dtype must "
                f"stay None, got {self.gather_dtype!r}")
        if self.reduce_wire == "q8_block" and not self.sharded:
            raise ValueError(
                "reduce_wire='q8_block' quantizes the gradient "
                "reduce-scatter; a schedule-unsharded (replicated) group "
                "has no reduce-scatter to quantize -- its grads are "
                "psum'd in full precision")
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

    def describe(self) -> str:
        return (f"prefetch={int(self.prefetch)} "
                f"reshard={int(self.reshard_after_forward)} "
                f"keep_last={int(self.keep_last_gathered)} "
                f"mode={self.gather_mode} "
                f"rmode={self.reduce_mode} "
                f"store={self.param_store} "
                f"gather={self.gather_dtype or 'compute'} "
                f"reduce={self.reduce_wire or self.reduce_dtype or 'wire'}"
                + (f" chunk={self.ring_chunk_elems}"
                   if self.ring_chunk_elems is not None else ""))


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


# The reference's named variants: on one rank every VARIANTS entry trains
# bitwise like the default, and each ring variant like its xla twin.
VARIANTS: dict[str, CommSchedule] = {
    "default": CommSchedule(),
    "prefetch": CommSchedule(prefetch=True),
    "no_reshard": CommSchedule(reshard_after_forward=False),
    "keep_last": CommSchedule(keep_last_gathered=True),
    "fp32_wire": CommSchedule(gather_dtype="fp32"),
    "fp32_reduce": CommSchedule(reduce_dtype="fp32"),
    "overlap_all": CommSchedule(prefetch=True, keep_last_gathered=True,
                                reduce_dtype="fp32"),
    "ring": CommSchedule(gather_mode="ring"),
    "ring_overlap": CommSchedule(gather_mode="ring", prefetch=True,
                                 keep_last_gathered=True,
                                 reduce_dtype="fp32"),
}

# Variants that change the numerics, not only the comm path: ring_acc
# reduces in ring order, the quantized stores train on decoded weights and
# the q8 reduce wire on quantized gradients.
APPROX_VARIANTS: dict[str, CommSchedule] = {
    "ring_acc": CommSchedule(gather_mode="ring", reduce_mode="ring_acc",
                             reduce_dtype="fp32"),
    "q8_store": CommSchedule(param_store="q8_block"),
    "q8_ring_prefetch": CommSchedule(param_store="q8_block",
                                     gather_mode="ring", prefetch=True),
    "q8_reduce": CommSchedule(reduce_wire="q8_block"),
    "q8_both_wires": CommSchedule(param_store="q8_block",
                                  reduce_wire="q8_block"),
    "q8_reduce_ring_acc": CommSchedule(gather_mode="ring",
                                       reduce_mode="ring_acc",
                                       reduce_wire="q8_block"),
    "q8_serve_matmul": CommSchedule(param_store="q8_block",
                                    serve_quant_matmul=True),
    "fp8_store": CommSchedule(param_store="fp8_e4m3"),
    "fp8_e5m2_store": CommSchedule(param_store="fp8_e5m2"),
    "fp8_ring_prefetch": CommSchedule(param_store="fp8_e4m3",
                                      gather_mode="ring", prefetch=True),
}
