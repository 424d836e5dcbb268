"""ShardingPolicy / ShardingPlan: the planning front-end (port of
``repro/core/policy.py``).

  * ``ShardingPolicy`` -- one group's complete policy, a typed 1:1 view
    over ``CommSchedule`` (which validates it).
  * ``PolicyRule`` -- a selector plus a policy: a name glob (``match=``),
    a structural tag (``tag=``: layers, experts or globals) and a predicate
    over the group's ``GroupInfo`` (``where=``); criteria AND together and
    rules compose first-match-wins in a ``PolicySet``.  A rule that matches
    no group raises at planning time.
  * ``ShardingPlan`` -- the resolved artifact: per group the winning
    policy, the planner's placements and the mesh-axis decomposition, with
    the wire-byte accounting, ``describe()`` (the audit table),
    ``to_json``/``dumps``/``from_json`` (plan JSON version 3) and ``diff``.

  * ``CostModel`` / ``auto_policies`` -- ``policies="auto"``: per group
    the store format, gather mode, reduce wire, ring chunk and replication
    with the least predicted comm time, priced by the closed-form roofline
    over the ``launch/mesh.py`` constants (the H100's) or by a measured
    ``CommProfile`` (``CostModel.from_profile``).  An auto plan records
    the profile's name and content hash and, per group, the chosen
    policy's price under the model and under the builtin roofline
    (``pricing``: ``describe()``'s ``auto_ms``/``builtin_ms`` columns).

``FSDPRuntime`` takes, by default, the legacy ``ParallelConfig`` knobs
lowered onto a ``PolicySet`` (``PolicySet.from_parallel_config``: a default
policy plus one exact-name rule per ``group_schedules`` entry).  A plan
that no cost model priced carries the profile ``{"name": "none", "hash":
""}`` and an empty pricing table, as the reference's does.

PARITY: BITWISE -- pure metadata and Python float arithmetic in the
reference's order; every resolved plan entry, every cost-model price and
``dumps()`` string equals the reference's under the same constants and
profile.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import glob as _glob
import json
import re
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from .planner import get_planner, plan_group
from .profile import CommProfile, builtin_profile, load_profile
from .ragged import LANE, GroupPlan, Placement, TensorSpec, \
    compose_granularity
from .schedule import CommSchedule, resolve_group_schedules
from .store import ParamStore
from .wire import STORE_FORMATS, WireCodec

# structural tags a PolicyRule can select on (see group_tag)
TAGS = ("layers", "experts", "globals")

# one layer scan gathers several groups per step, so these knobs must agree
# across groups and always come from the PolicySet default
STRUCTURE_FIELDS = ("prefetch", "reshard_after_forward", "keep_last_gathered",
                    "serve_quant_matmul")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """One communication group's complete sharding policy: a typed 1:1
    view over ``CommSchedule`` (which validates it)."""

    store: str = "fp32"
    gather_mode: str = "xla"
    reduce_mode: str = "match"
    gather_dtype: Optional[str] = None
    reduce_dtype: Optional[str] = None
    reduce_wire: Optional[str] = None
    prefetch: bool = False
    reshard_after_forward: bool = True
    keep_last_gathered: bool = False
    sharded: bool = True
    serve_quant_matmul: bool = False
    ring_chunk_elems: Optional[int] = None

    def __post_init__(self):
        self.to_schedule()

    def to_schedule(self) -> CommSchedule:
        return CommSchedule(
            prefetch=self.prefetch,
            reshard_after_forward=self.reshard_after_forward,
            keep_last_gathered=self.keep_last_gathered,
            gather_dtype=self.gather_dtype,
            reduce_dtype=self.reduce_dtype,
            gather_mode=self.gather_mode,
            reduce_mode=self.reduce_mode,
            param_store=self.store,
            reduce_wire=self.reduce_wire,
            sharded=self.sharded,
            serve_quant_matmul=self.serve_quant_matmul,
            ring_chunk_elems=self.ring_chunk_elems,
        )

    @classmethod
    def from_schedule(cls, sched: CommSchedule) -> "ShardingPolicy":
        return cls(
            store=sched.param_store,
            gather_mode=sched.gather_mode,
            reduce_mode=sched.reduce_mode,
            gather_dtype=sched.gather_dtype,
            reduce_dtype=sched.reduce_dtype,
            reduce_wire=sched.reduce_wire,
            prefetch=sched.prefetch,
            reshard_after_forward=sched.reshard_after_forward,
            keep_last_gathered=sched.keep_last_gathered,
            sharded=sched.sharded,
            serve_quant_matmul=sched.serve_quant_matmul,
            ring_chunk_elems=sched.ring_chunk_elems,
        )

    def describe(self) -> str:
        return (f"{self.store} {self.gather_mode}/{self.reduce_mode} "
                f"g={self.gather_dtype or 'compute'} "
                f"r={self.reduce_wire or self.reduce_dtype or 'wire'}"
                + (f" chunk={self.ring_chunk_elems}"
                   if self.ring_chunk_elems is not None else "")
                + ("" if self.sharded else " replicated"))


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """What a PolicyRule selector sees of one communication group."""

    name: str
    tag: str
    n_layers: Optional[int]
    specs: tuple[TensorSpec, ...]

    @property
    def payload(self) -> int:
        """Logical elements across the whole layer stack."""
        return sum(s.size for s in self.specs) * (self.n_layers or 1)


def group_tag(name: str, gdef) -> str:
    if "expert" in name:
        return "experts"
    return "layers" if gdef.n_layers else "globals"


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """Selector + policy.  Criteria AND together; at least one required."""

    policy: ShardingPolicy
    match: Optional[str] = None
    tag: Optional[str] = None
    where: Optional[Callable[[GroupInfo], bool]] = None

    def __post_init__(self):
        if self.match is None and self.tag is None and self.where is None:
            raise ValueError(
                "PolicyRule needs at least one selector (match=, tag=, or "
                "where=); to change the default policy, set PolicySet.default")
        if self.tag is not None and self.tag not in TAGS:
            raise ValueError(
                f"unknown PolicyRule tag {self.tag!r}; expected one of "
                f"{list(TAGS)}")

    def matches(self, info: GroupInfo) -> bool:
        if self.match is not None and not fnmatch.fnmatchcase(
                info.name, self.match):
            return False
        if self.tag is not None and info.tag != self.tag:
            return False
        if self.where is not None and not self.where(info):
            return False
        return True

    def selector(self) -> str:
        parts = []
        if self.match is not None:
            parts.append(f"match={self.match!r}")
        if self.tag is not None:
            parts.append(f"tag={self.tag!r}")
        if self.where is not None:
            parts.append(f"where={getattr(self.where, '__name__', 'fn')}")
        return " ".join(parts)


@dataclasses.dataclass(frozen=True)
class PolicySet:
    """First-match-wins rules over a default policy."""

    rules: tuple[PolicyRule, ...] = ()
    default: ShardingPolicy = ShardingPolicy()

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in self.rules:
            bad = [f for f in STRUCTURE_FIELDS
                   if getattr(r.policy, f) != getattr(self.default, f)]
            if bad:
                raise ValueError(
                    f"PolicyRule ({r.selector()}) changes scan-structure "
                    f"knobs {bad}: one layer scan gathers several groups, so "
                    f"{list(STRUCTURE_FIELDS)} come from PolicySet.default")

    def policy_for(self, info: GroupInfo) -> tuple[ShardingPolicy,
                                                   Optional[int]]:
        """(policy, index of the matching rule or None for the default)."""
        for i, r in enumerate(self.rules):
            if r.matches(info):
                return r.policy, i
        return self.default, None

    @classmethod
    def from_parallel_config(cls, par, schedule: CommSchedule | None = None,
                             group_schedules=None) -> "PolicySet":
        """Lower the ``ParallelConfig`` knob surface (or explicit
        ``schedule=``/``group_schedules=`` overrides of it) onto a default
        policy plus one exact-name rule per ``group_schedules`` entry."""
        base = schedule if schedule is not None \
            else CommSchedule.from_parallel(par)
        overrides = (par.group_schedules if group_schedules is None
                     else group_schedules)
        scheds = resolve_group_schedules(base, overrides)
        rules = tuple(
            PolicyRule(match=_glob.escape(name),
                       policy=ShardingPolicy.from_schedule(s))
            for name, s in scheds.items())
        return cls(rules=rules, default=ShardingPolicy.from_schedule(base))


def store_for(policy: ShardingPolicy, quant_block: int, m: int) -> ParamStore:
    """THE policy -> ParamStore mapping: the EF residual exists iff the
    policy's reduce wire is quantized, sized by the group's FSDP world m.
    ``plan()``'s align and shard-size checks and ``GroupPlanEntry.store``
    both use it, so the two cannot diverge."""
    return ParamStore(policy.store, quant_block,
                      ef_m=m if policy.to_schedule().ef_enabled else 0)


def _torch_dtype(name) -> torch.dtype:
    """A compute dtype given as a torch dtype or its name ("bfloat16")."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class GroupPlanEntry:
    """One group's resolved slice of a ShardingPlan: the policy that won,
    the planner's placements and the mesh-axis decomposition.  An
    unsharded (``sharded=False``) group has no ``fsdp_axes``; the axes it
    would have been sharded on are its ``grad_sync_axes``, over which its
    gradient is all-reduced."""

    name: str
    tag: str
    policy: ShardingPolicy
    local_specs: tuple[TensorSpec, ...]
    plan: GroupPlan
    fsdp_axes: tuple[str, ...]
    fsdp_axis_sizes: tuple[int, ...]
    outer_axis: Optional[str]
    outer_size: int
    n_layers: Optional[int]
    grad_sync_axes: tuple[str, ...]
    quant_block: int
    # tensor name -> dim split over ``outer_axis`` before FSDP packing
    outer_dims: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @property
    def fsdp_world(self) -> int:
        """The group's FSDP world size m (1 for an unsharded group)."""
        return int(np.prod(self.fsdp_axis_sizes)) if self.fsdp_axes else 1

    @property
    def store(self) -> ParamStore:
        return store_for(self.policy, self.quant_block, self.fsdp_world)

    def schedule(self) -> CommSchedule:
        return self.policy.to_schedule()

    def gather_wire_bytes(self, compute_dtype) -> int:
        """Bytes one forward pass's all-gathers of this group put on the
        wire, per gathered copy (an unsharded group moves nothing)."""
        if not self.fsdp_axes:
            return 0
        cd = _torch_dtype(compute_dtype)
        per_layer = self.store.wire_bytes(self.plan.total,
                                          self.schedule().wire_dtype(cd))
        return per_layer * (self.n_layers or 1)

    def reduce_wire_bytes(self, compute_dtype) -> int:
        """Bytes one gradient reduce-scatter of this group puts on the
        wire, per reduced copy, in its reduce codec.  The order-exact
        routes (the ring gather mode's match reduce, and any match-mode q8
        reduce, which route un-reduced chunks) carry m/2 times the payload
        of the bandwidth-optimal routes; an unsharded group counts zero
        (its all-reduce is not a reduce-scatter)."""
        if not self.fsdp_axes:
            return 0
        sched = self.schedule()
        codec = sched.reduce_codec(_torch_dtype(compute_dtype),
                                   self.quant_block)
        per = codec.wire_bytes(self.plan.total)
        m = self.fsdp_world
        order_exact = (sched.reduce_mode == "match"
                       and (codec.quantized or sched.gather_mode == "ring"))
        if order_exact and m > 1:
            per = per * m // 2
        return per * (self.n_layers or 1)

    def param_bytes(self) -> int:
        """Stored bytes per rank of this group's parameter state across its
        layer stack: per element 4 (fp32), 2 (bf16), 5 (fp8 codes + fp32
        master) or 5 + 4 / block (q8_block), plus 4 * m for the q8 reduce
        wire's residual (m shard-lengths of fp32).  PARITY: BITWISE vs the
        reference's ``GroupPlanEntry.param_bytes``."""
        s = self.store
        if s.quantized:
            per_elem = 1 + 4 + 4.0 / s.block
        elif s.fp8:
            per_elem = 1 + 4
        else:
            per_elem = s.storage_dtype.itemsize
        per_elem += 4.0 * s.ef_m
        local = self.plan.shard_size if self.fsdp_axes else self.plan.total
        return int(local * per_elem * (self.n_layers or 1))

    def invariants(self, compute_dtype) -> tuple[dict, ...]:
        """The group's declared invariants: what ``analysis.verify`` proves
        about the traced step under this policy.  Each is a plain dict
        (name, group, class and parameters; dtypes by name) so that the
        declaration serializes beside the plan: ``comm_bytes`` (the wire
        legs of one gather copy, the reduce route and dtypes, the bytes
        per copy), ``wire_dtype``, ``ring_chunk`` (the block-aligned snap
        the declaration promises beside the unit-1 snap the gather
        performs), ``no_f32_dequant`` and ``ef_threading``.  PARITY:
        BITWISE -- the reference's dicts, ``==``."""
        from .wire import _snap_chunk

        sched = self.schedule()
        cd = _torch_dtype(compute_dtype)
        inv: list[dict] = []
        if self.fsdp_axes and self.fsdp_world > 1:
            shard = self.plan.shard_size
            if self.store.quantized:
                legs = (("int8", shard),
                        ("float32", shard // self.quant_block))
            elif self.store.fp8:
                legs = ((dtype_name(self.store.fp8_dtype), shard),)
            else:
                legs = ((dtype_name(sched.wire_dtype(cd)), shard),)
            rcodec = sched.reduce_codec(cd, self.quant_block)
            ring_gather = sched.gather_mode == "ring"
            ring_reduce = (sched.reduce_mode == "ring_acc"
                           or (sched.reduce_mode == "match"
                               and (rcodec.quantized or ring_gather)))
            if rcodec.quantized:
                rdtypes = ("int8", "float32")
            else:
                rdtypes = (dtype_name(sched.accum_dtype(cd)),)
            inv.append({
                "name": "comm_bytes", "group": self.name,
                "class": "exact",
                "gather_legs": legs,
                "reduce_route": ("ring" if ring_reduce else "psum_scatter"),
                "reduce_dtypes": rdtypes,
                "gather_mb_per_copy": self.gather_wire_bytes(cd) / 1e6
                / (self.n_layers or 1),
                "reduce_mb_per_copy": self.reduce_wire_bytes(cd) / 1e6
                / (self.n_layers or 1),
            })
            inv.append({
                "name": "wire_dtype", "group": self.name, "class": "exact",
                "legal": sorted({d for d, _ in legs} | set(rdtypes)),
            })
            if ring_gather or ring_reduce:
                unit = self.quant_block if self.store.quantized else 1
                declared = sched.ring_chunk_elems
                inv.append({
                    "name": "ring_chunk", "group": self.name,
                    "class": "exact", "declared": declared,
                    "snapped": _snap_chunk(shard, declared, unit),
                    "wire": _snap_chunk(shard, declared),
                    "unit": unit,
                })
        if self.store.quantized and cd != torch.float32:
            inv.append({"name": "no_f32_dequant", "group": self.name,
                        "class": "exact", "src_dtype": "int8",
                        "gathered_elems": int(self.plan.total)})
        if self.store.fp8 and cd != torch.float32:
            # the fused gather decode is one fp8 -> compute cast
            inv.append({"name": "no_f32_dequant", "group": self.name,
                        "class": "exact",
                        "src_dtype": dtype_name(self.store.fp8_dtype),
                        "gathered_elems": int(self.plan.total)})
        if sched.ef_enabled:
            inv.append({"name": "ef_threading", "group": self.name,
                        "class": "exact"})
        return tuple(inv)


def dtype_name(dtype) -> str:
    """A dtype's bare name as the reference spells it ("bfloat16",
    "float8_e4m3fn"), from a torch dtype, a numpy-like dtype or a name."""
    return str(dtype).rsplit(".", 1)[-1]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """The resolved planning artifact the runtime consumes.  Inspect it
    with ``describe()``, serialize it with ``to_json``/``dumps`` and
    compare it with ``diff``; ``from_json(to_json())`` rebuilds the same
    layout (placements carry name, shape, dtype, granularity and
    offset)."""

    base: ShardingPolicy
    groups: Mapping[str, GroupPlanEntry]
    axis_sizes: Mapping[str, int]
    planner: str
    compute_dtype: str  # dtype name, e.g. "bfloat16"
    # the comm profile a cost model priced the plan with ("none": not
    # priced) and its per-group pricing table
    profile_name: str = "none"
    profile_hash: str = ""
    pricing: Mapping[str, Mapping[str, float]] = dataclasses.field(
        default_factory=dict)

    def base_schedule(self) -> CommSchedule:
        return self.base.to_schedule()

    def schedules(self) -> dict[str, CommSchedule]:
        return {n: e.schedule() for n, e in self.groups.items()}

    def policy_set(self) -> PolicySet:
        """The plan's policies as an exact-name PolicySet (re-planning the
        same model under the same per-group decisions)."""
        return PolicySet(
            rules=tuple(PolicyRule(match=n, policy=e.policy)
                        for n, e in self.groups.items()
                        if e.policy != self.base),
            default=self.base)

    def gather_wire_bytes(self) -> int:
        return sum(e.gather_wire_bytes(self.compute_dtype)
                   for e in self.groups.values())

    def reduce_wire_bytes(self) -> int:
        return sum(e.reduce_wire_bytes(self.compute_dtype)
                   for e in self.groups.values())

    def invariants(self) -> tuple[dict, ...]:
        """The plan's declared invariants: every group's
        (``GroupPlanEntry.invariants``) plus those only the whole plan can
        state -- ``gathered_peak``, the slots of gathered layer buffers the
        layer loop's structure bounds, and for a priced plan
        ``profile_fresh`` (a warning).  ``analysis.verify`` checks them.
        PARITY: BITWISE -- the reference's dicts, ``==``."""
        inv: list[dict] = []
        for e in self.groups.values():
            inv.extend(e.invariants(self.compute_dtype))
        sched = self.base_schedule()
        layered = {n: e for n, e in self.groups.items()
                   if e.n_layers and e.fsdp_axes and e.fsdp_world > 1}
        if layered:
            n = max(e.n_layers for e in layered.values())
            if not sched.reshard_after_forward:
                slots = n
            else:
                lp = sched.plan_layers(n, remat=True)
                main_slots = (2 if lp.prefetch else 1) if lp.main else 0
                slots = main_slots + int(lp.split_last)
            inv.append({
                "name": "gathered_peak", "group": "*", "class": "exact",
                "max_slots": slots,
                "groups": {name: {"elems": int(e.plan.total)}
                           for name, e in layered.items()},
            })
        if self.profile_name != "none":
            inv.append({
                "name": "profile_fresh", "group": "*", "class": "warn",
                "profile": self.profile_name, "hash": self.profile_hash,
            })
        return tuple(inv)

    def describe(self) -> str:
        """The audit table: per group the policy, shard size S, padding and
        the wire bytes of both directions."""
        mesh = ",".join(f"{a}={s}" for a, s in self.axis_sizes.items())
        head = (f"ShardingPlan mesh[{mesh}] planner={self.planner} "
                f"compute={self.compute_dtype} "
                f"scan[prefetch={int(self.base.prefetch)} "
                f"reshard={int(self.base.reshard_after_forward)} "
                f"keep_last={int(self.base.keep_last_gathered)}]")
        if self.profile_name != "none":
            head += f" profile={self.profile_name}@{self.profile_hash}"
        cols = ["group", "tag", "L", "m", "S", "pad%", "policy",
                "gather_wire_mb", "reduce_wire_mb"]
        priced = bool(self.pricing)
        if priced:
            cols += ["auto_ms", "builtin_ms"]
        rows = []
        for name, e in self.groups.items():
            rows.append([
                name, e.tag, str(e.n_layers or "-"), str(e.fsdp_world),
                str(e.plan.shard_size),
                f"{100 * e.plan.padding_ratio:.2f}",
                e.policy.describe(),
                f"{e.gather_wire_bytes(self.compute_dtype) / 1e6:.3f}",
                f"{e.reduce_wire_bytes(self.compute_dtype) / 1e6:.3f}",
            ])
            if priced:
                p = self.pricing.get(name, {})
                rows[-1] += [f"{p.get('auto_ms', 0.0):.4f}",
                             f"{p.get('builtin_ms', 0.0):.4f}"]
        widths = [max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
                  for i, c in enumerate(cols)]
        lines = [head, "  ".join(c.ljust(w) for c, w in zip(cols, widths))]
        lines += ["  ".join(v.ljust(w) for v, w in zip(r, widths))
                  for r in rows]
        return "\n".join(lines)

    def to_json(self) -> dict:
        """The plan as JSON-ready data, version 3 (per-group
        ``outer_dims``, the pricing provenance ``profile`` and the
        ``pricing`` table)."""
        return {
            "version": 3,
            "axis_sizes": {a: int(s) for a, s in self.axis_sizes.items()},
            "planner": self.planner,
            "compute_dtype": self.compute_dtype,
            "profile": {"name": self.profile_name,
                        "hash": self.profile_hash},
            "pricing": {name: {k: float(v) for k, v in p.items()}
                        for name, p in self.pricing.items()},
            "base": dataclasses.asdict(self.base),
            "groups": {
                name: {
                    "tag": e.tag,
                    "policy": dataclasses.asdict(e.policy),
                    "shard_size": e.plan.shard_size,
                    "num_shards": e.plan.num_shards,
                    "mode": e.plan.mode,
                    "padding": e.plan.padding,
                    "n_layers": e.n_layers,
                    "outer_axis": e.outer_axis,
                    "outer_size": e.outer_size,
                    "outer_dims": {k: int(v)
                                   for k, v in e.outer_dims.items()},
                    "fsdp_axes": list(e.fsdp_axes),
                    "fsdp_axis_sizes": [int(s) for s in e.fsdp_axis_sizes],
                    "grad_sync_axes": list(e.grad_sync_axes),
                    "quant_block": e.quant_block,
                    "gather_wire_mb": round(
                        e.gather_wire_bytes(self.compute_dtype) / 1e6, 6),
                    "reduce_wire_mb": round(
                        e.reduce_wire_bytes(self.compute_dtype) / 1e6, 6),
                    "param_mb": round(e.param_bytes() / 1e6, 6),
                    "placements": [
                        {"name": p.spec.name, "shape": list(p.spec.shape),
                         "dtype": p.spec.dtype,
                         "granularity": p.spec.granularity,
                         "offset": p.offset}
                        for p in e.plan.placements],
                }
                for name, e in self.groups.items()
            },
        }

    def dumps(self) -> str:
        """Canonical JSON (sorted keys): plan equality is string equality
        of ``dumps()``."""
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "ShardingPlan":
        groups = {}
        for name, g in data["groups"].items():
            placements = tuple(
                Placement(TensorSpec(p["name"], tuple(p["shape"]),
                                     p.get("dtype", "float32"),
                                     p["granularity"]),
                          p["offset"])
                for p in g["placements"])
            gplan = GroupPlan(placements, shard_size=g["shard_size"],
                              num_shards=g["num_shards"], mode=g["mode"])
            groups[name] = GroupPlanEntry(
                name=name, tag=g["tag"],
                policy=ShardingPolicy(**g["policy"]),
                local_specs=tuple(p.spec for p in placements),
                plan=gplan,
                fsdp_axes=tuple(g["fsdp_axes"]),
                fsdp_axis_sizes=tuple(g["fsdp_axis_sizes"]),
                outer_axis=g["outer_axis"], outer_size=g["outer_size"],
                n_layers=g["n_layers"],
                grad_sync_axes=tuple(g["grad_sync_axes"]),
                quant_block=g["quant_block"],
                outer_dims={k: int(v)
                            for k, v in g.get("outer_dims", {}).items()})
        prof = data.get("profile", {})
        return cls(base=ShardingPolicy(**data["base"]), groups=groups,
                   axis_sizes=dict(data["axis_sizes"]),
                   planner=data["planner"],
                   compute_dtype=data["compute_dtype"],
                   profile_name=prof.get("name", "none"),
                   profile_hash=prof.get("hash", ""),
                   pricing={name: {k: float(v) for k, v in p.items()}
                            for name, p in data.get("pricing", {}).items()})

    def diff(self, other: "ShardingPlan") -> list[str]:
        """Field-level differences against ``other`` (empty: the plans are
        identical)."""
        out: list[str] = []

        def walk(path, a, b):
            if isinstance(a, dict) and isinstance(b, dict):
                for k in sorted(set(a) | set(b)):
                    if k not in a:
                        out.append(f"{path}{k}: <absent> != {b[k]!r}")
                    elif k not in b:
                        out.append(f"{path}{k}: {a[k]!r} != <absent>")
                    else:
                        walk(f"{path}{k}.", a[k], b[k])
            elif a != b:
                out.append(f"{path[:-1]}: {a!r} != {b!r}")

        walk("", self.to_json(), other.to_json())
        return out


# fields of a group's JSON entry whose change means its stored bytes cannot
# move bitwise from one plan to the other
_LAYOUT_FIELDS = frozenset({
    "shard_size", "num_shards", "mode", "n_layers", "outer_axis",
    "outer_size", "outer_dims", "fsdp_axes", "fsdp_axis_sizes",
    "grad_sync_axes", "placements", "quant_block",
})
_LAYOUT_POLICY_FIELDS = frozenset({"store", "reduce_wire"})


def layout_changed_groups(old: ShardingPlan, new: ShardingPlan) -> set[str]:
    """Groups whose stored bytes cannot move bitwise from ``old`` to
    ``new``: the layout or the stored format (store, the residual through
    ``reduce_wire``) differs, read off ``ShardingPlan.diff``; a group
    present in one plan only counts as changed."""
    changed: set[str] = set(old.groups) ^ set(new.groups)
    pat = re.compile(r"^groups\.([^.]+)\.([^.:]+)")
    for line in old.diff(new):
        m = pat.match(line)
        if not m:
            continue
        gname, field = m.group(1), m.group(2)
        if field in _LAYOUT_FIELDS:
            changed.add(gname)
        elif field == "policy":
            sub = re.match(r"^groups\.[^.]+\.policy\.([^.:]+)", line)
            if sub and sub.group(1) in _LAYOUT_POLICY_FIELDS:
                changed.add(gname)
    return changed & (set(old.groups) | set(new.groups))



# --------------------------------------------------------------------------- #
# the auto planner's cost model
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class CostModel:
    """The terms ``policies="auto"`` scores candidate policies with.

    * **builtin roofline** (``profile`` None or a ``builtin=True``
      profile): ``gathers_per_step * wire_bytes * (m-1)/m / ici_bw`` per
      group, plus, for coded payloads, the analytic encode/decode HBM
      traffic, and a per-collective issue latency per mode (one
      ``xla_latency_s`` for the collective, ``ring_hop_latency_s`` per hop
      of a ring: m - 1 hops).
    * **measured profile** (``from_profile``): per (direction, fmt, mode)
      latency/bandwidth lines fitted from a ``CommProfile``; end-to-end
      curves include the codec cost, so no HBM term is added.

    The candidate with the least predicted time wins, ties toward the
    earlier (more exact) one, so one rank (m = 1) keeps fp32 everywhere.
    The fp8 stores compete only on a measured fp8 gather curve and must
    beat the incumbent by more than ``FP8_NEAR_TIE_RTOL``.  Small
    unstacked groups (at most ``replicate_bytes`` of fp32 master) stay
    replicated: their gather latency outweighs the memory a shard saves.
    """

    ici_bw: float
    hbm_bw: float
    peak_flops: float
    xla_latency_s: float = 5e-6       # per collective issue
    ring_hop_latency_s: float = 5e-6  # per ring hop (a ring pays m - 1)
    replicate_bytes: int = 4 << 20
    profile: Optional[CommProfile] = None

    # store formats in preference order (ties break toward the left)
    CANDIDATES = ("fp32", "bf16", "q8_block")
    # scored after CANDIDATES, on measured evidence only
    FP8_CANDIDATES = tuple(f for f in STORE_FORMATS if f.startswith("fp8_"))
    FP8_NEAR_TIE_RTOL = 0.02
    # gather modes in preference order (xla wins ties)
    GATHER_MODES = ("xla", "ring")

    @classmethod
    def default(cls) -> "CostModel":
        """The builtin roofline over ``launch.mesh``'s constants (read at
        call time)."""
        from ..launch import mesh

        return cls(ici_bw=mesh.ICI_BW, hbm_bw=mesh.HBM_BW,
                   peak_flops=mesh.PEAK_FLOPS_BF16)

    @classmethod
    def from_profile(cls, profile, hbm_bw: float | None = None,
                     peak_flops: float | None = None) -> "CostModel":
        """A CostModel pricing from a measured ``CommProfile`` (the object
        or a path to one).  ``ici_bw`` is back-derived from the fitted fp32
        gather curve (for reporting and for curves the profile lacks); the
        HBM and FLOP rates stay ``launch.mesh``'s."""
        from ..launch import mesh

        if not isinstance(profile, CommProfile):
            profile = load_profile(profile)
        ici = mesh.ICI_BW
        for mode in ("xla", "ring"):
            if profile.has("gather", "fp32", mode):
                _, slope = profile.linear("gather", "fp32", mode)
                if slope > 0:
                    ici = 4.0 / slope  # fp32: 4 wire bytes per element
                    break
        return cls(ici_bw=ici, hbm_bw=hbm_bw or mesh.HBM_BW,
                   peak_flops=peak_flops or mesh.PEAK_FLOPS_BF16,
                   profile=profile)

    # ---- provenance ------------------------------------------------------ #
    @property
    def measured(self) -> bool:
        return self.profile is not None and not self.profile.builtin

    def provenance_profile(self) -> CommProfile:
        """The profile this model prices with: the attached one, or the
        builtin roofline rendered from its own constants."""
        if self.profile is not None:
            return self.profile
        return builtin_profile(self.ici_bw, self.xla_latency_s)

    # ---- shared pricing helpers ------------------------------------------ #
    def _latency(self, mode: str, m: int) -> float:
        """Issue latency under the roofline: none at m = 1; one xla issue,
        or m - 1 ring hops."""
        if m <= 1:
            return 0.0
        if mode == "xla":
            return self.xla_latency_s
        return self.ring_hop_latency_s * (m - 1)

    def _measured_time(self, direction: str, fmt: str, mode: str,
                       elems: float, m: int) -> Optional[float]:
        """One collective's seconds from the measured curve (None without
        a measured entry for the key); the fitted slope carries the
        profile world's (w-1)/w ring volume, rescaled to the group's m (0
        at m = 1)."""
        if not (self.measured and self.profile.has(direction, fmt, mode)):
            return None
        lat, slope = self.profile.linear(direction, fmt, mode)
        w = self.profile.world
        rw = (w - 1) / w if w > 1 else 1.0
        rm = (m - 1) / m if m > 1 else 0.0
        return lat + elems * slope * (rm / rw)

    def gather_time(self, fmt: str, elems_per_layer: int, n_layers: int,
                    m: int, quant_block: int, compute_itemsize: int,
                    reshard: bool = True, mode: str = "xla") -> float:
        """Predicted per-step parameter-gather seconds of one group under
        store ``fmt`` and gather ``mode`` (forward and, when resharding,
        the backward re-gather)."""
        gathers = 2.0 if reshard else 1.0
        measured = self._measured_time("gather", fmt, mode,
                                       elems_per_layer, m)
        if measured is not None:
            t = gathers * n_layers * measured
            if not self.profile.end_to_end and fmt == "q8_block":
                deq = elems_per_layer * (
                    1 + 4.0 / quant_block + compute_itemsize)
                t += gathers * n_layers * deq / self.hbm_bw
            if not self.profile.end_to_end and fmt.startswith("fp8_"):
                # scale-free decode: fp8 codes in, compute dtype out
                deq = elems_per_layer * (1 + compute_itemsize)
                t += gathers * n_layers * deq / self.hbm_bw
            return t
        store = ParamStore(fmt, quant_block)
        # only the itemsize matters
        wire_dtype = torch.float32 if compute_itemsize == 4 else torch.float16
        wire = store.wire_bytes(elems_per_layer, wire_dtype)
        ring = (m - 1) / m if m > 1 else 0.0
        t = gathers * n_layers * (
            wire * ring / self.ici_bw + self._latency(mode, m))
        if store.quantized:
            # local decode: codes and scales in, compute dtype out
            deq = elems_per_layer * (1 + 4.0 / quant_block + compute_itemsize)
            t += gathers * n_layers * deq / self.hbm_bw
        elif store.fp8:
            deq = elems_per_layer * (1 + compute_itemsize)
            t += gathers * n_layers * deq / self.hbm_bw
        return t

    def choose_store(self, elems_per_layer: int, n_layers: int, m: int,
                     quant_block: int, compute_itemsize: int,
                     reshard: bool = True, mode: str = "xla") -> str:
        best, best_t = None, None
        for fmt in self.CANDIDATES:
            t = self.gather_time(fmt, elems_per_layer, n_layers, m,
                                 quant_block, compute_itemsize, reshard,
                                 mode)
            if best_t is None or t < best_t:
                best, best_t = fmt, t
        for fmt in self.FP8_CANDIDATES:
            if self._measured_time("gather", fmt, mode,
                                   elems_per_layer, m) is None:
                continue  # fp8 competes on measured evidence only
            t = self.gather_time(fmt, elems_per_layer, n_layers, m,
                                 quant_block, compute_itemsize, reshard,
                                 mode)
            if t < best_t * (1.0 - self.FP8_NEAR_TIE_RTOL):
                best, best_t = fmt, t
        return best

    def choose_gather(self, elems_per_layer: int, n_layers: int, m: int,
                      quant_block: int, compute_itemsize: int,
                      reshard: bool = True) -> tuple[str, str]:
        """Joint (store format, gather mode) choice: strict less-than over
        formats, then modes, xla first -- so under the roofline (where a
        ring never strictly beats the collective) it matches
        ``choose_store``."""
        best, best_t = None, None
        for fmt in self.CANDIDATES:
            for mode in self.GATHER_MODES:
                t = self.gather_time(fmt, elems_per_layer, n_layers, m,
                                     quant_block, compute_itemsize, reshard,
                                     mode)
                if best_t is None or t < best_t:
                    best, best_t = (fmt, mode), t
        for fmt in self.FP8_CANDIDATES:
            for mode in self.GATHER_MODES:
                if self._measured_time("gather", fmt, mode,
                                       elems_per_layer, m) is None:
                    continue
                t = self.gather_time(fmt, elems_per_layer, n_layers, m,
                                     quant_block, compute_itemsize, reshard,
                                     mode)
                if t < best_t * (1.0 - self.FP8_NEAR_TIE_RTOL):
                    best, best_t = (fmt, mode), t
        return best

    # ---- reduce direction (the gradient wire) ---------------------------- #
    # None keeps the cast wire (exact); "q8_block" is the quantized
    # gradient wire.  Ties break toward the exact wire.
    REDUCE_CANDIDATES = (None, "q8_block")

    def reduce_time(self, fmt: Optional[str], elems_per_layer: int,
                    n_layers: int, m: int, quant_block: int,
                    compute_itemsize: int,
                    mode: Optional[str] = None) -> float:
        """Predicted per-step gradient reduce-scatter seconds of one group
        under reduce wire ``fmt`` (one reduce per layer and step); the q8
        wire adds its encode/decode HBM traffic and the residual's read
        and write.  ``mode`` is the route (xla, ring, ring_acc); None
        takes the one ``auto_policies`` pairs with the wire: xla for a
        cast wire, ring_acc for q8."""
        codec = (WireCodec("q8_block", quant_block) if fmt == "q8_block"
                 else WireCodec("fp32" if compute_itemsize == 4 else "bf16"))
        if mode is None:
            mode = "ring_acc" if codec.quantized else "xla"
        measured = self._measured_time("reduce", codec.fmt, mode,
                                       elems_per_layer, m)
        if measured is not None and self.profile.end_to_end:
            return n_layers * measured
        wire = codec.wire_bytes(elems_per_layer)
        ring = (m - 1) / m if m > 1 else 0.0
        t = n_layers * (wire * ring / self.ici_bw + self._latency(mode, m))
        if codec.quantized:
            # encode (read fp32 ct + ef, write codes, scales, ef) and decode
            # (read m contributions' codes and scales, write the fp32 shard)
            enc = elems_per_layer * (4 + 1 + 4.0 / quant_block + 2 * 4)
            dec = elems_per_layer * (1 + 4.0 / quant_block) + 4 * (
                elems_per_layer / max(m, 1))
            t += n_layers * (enc + dec) / self.hbm_bw
        return t

    def choose_reduce_wire(self, elems_per_layer: int, n_layers: int,
                           m: int, quant_block: int,
                           compute_itemsize: int) -> Optional[str]:
        best, best_t = None, None
        for fmt in self.REDUCE_CANDIDATES:
            t = self.reduce_time(fmt, elems_per_layer, n_layers, m,
                                 quant_block, compute_itemsize)
            if best_t is None or t < best_t:
                best, best_t = fmt, t
        return best

    # ---- ring chunking --------------------------------------------------- #
    def choose_ring_chunk(self, direction: str, fmt: str,
                          shard_elems: int) -> Optional[int]:
        """A ring group's message size from the measured profile's chunk
        sweep (None: keep the shard-sized default, always the answer under
        the roofline)."""
        if not self.measured:
            return None
        best = self.profile.best_ring_chunk(direction, fmt)
        if best is None or best >= shard_elems:
            return None
        return best


def auto_policies(model, axis_sizes: Mapping[str, int],
                  compute_dtype=None,
                  cost_model: CostModel | None = None) -> PolicySet:
    """``policies="auto"``: the cost model's choice for every group as an
    exact-name PolicySet (so the decisions stand in the ShardingPlan)."""
    cm = cost_model or CostModel.default()
    cfg = model.cfg
    cd = _torch_dtype(compute_dtype or torch.bfloat16)
    groups = model.groups()

    # overlap gathers where there is a stack to overlap
    max_layers = max((g.n_layers or 0) for g in groups.values())
    default = ShardingPolicy(
        prefetch=max_layers >= 3, keep_last_gathered=max_layers >= 3)

    rules = []
    for name, gdef in groups.items():
        elems, m, _axes = _group_shape(name, gdef, cfg.parallel, axis_sizes)
        n_layers = gdef.n_layers or 1
        master_bytes = elems * n_layers * 4  # fp32 master weights
        if gdef.n_layers is None and m > 1 and (
                master_bytes <= cm.replicate_bytes):
            pol = dataclasses.replace(default, sharded=False)
        else:
            fmt, gmode = cm.choose_gather(elems, n_layers, m,
                                          cfg.quant_block, cd.itemsize,
                                          reshard=default.reshard_after_forward)
            # the gradient direction: the q8 wire's residual does not
            # compose with accumulation or with replica gradient axes, so
            # only legal candidates are scored
            replica_grads = (
                ("pod" in axis_sizes and not cfg.parallel.pod_fsdp)
                or (gdef.replicated_over_model and cfg.parallel.tp > 1))
            rwire = (None if (cfg.parallel.microbatches > 1 or replica_grads)
                     else cm.choose_reduce_wire(elems, n_layers, m,
                                                cfg.quant_block,
                                                cd.itemsize))
            pol = dataclasses.replace(default, store=fmt, gather_mode=gmode,
                                      reduce_wire=rwire)
            if rwire == "q8_block":
                # priced on the bandwidth-optimal route: pair the q8 wire
                # with the accumulate-in-flight ring
                pol = dataclasses.replace(pol, reduce_mode="ring_acc")
            chunk = None
            if pol.gather_mode == "ring":
                chunk = cm.choose_ring_chunk("gather", fmt, elems // max(m, 1))
            elif pol.reduce_mode == "ring_acc" or pol.reduce_wire == "q8_block":
                rfmt = pol.reduce_wire or ("fp32" if cd.itemsize == 4
                                           else "bf16")
                chunk = cm.choose_ring_chunk("reduce", rfmt,
                                             elems // max(m, 1))
            if chunk is not None:
                pol = dataclasses.replace(pol, ring_chunk_elems=int(chunk))
        if pol != default:
            rules.append(PolicyRule(match=name, policy=pol))
    return PolicySet(rules=tuple(rules), default=default)


def _group_axes(name: str, gdef, par, axis_sizes: Mapping[str, int]):
    """The (outer_axis, outer_size, local_specs, fsdp_axes) decomposition
    of one group -- TP/EP outer sharding composed before FSDP."""
    outer_axis, outer_size = None, 1
    local_specs = []
    for s in gdef.specs:
        sd = gdef.outer.get(s.name)
        if sd is not None:
            outer_axis = sd.axis
            outer_size = axis_sizes[sd.axis]
            local_specs.append(compose_granularity(s, sd, outer_size))
        else:
            local_specs.append(s)
    if outer_axis or gdef.replicated_over_model:
        fsdp_axes = tuple(a for a in par.fsdp_axes if a != "model")
    else:
        fsdp_axes = tuple(a for a in par.fsdp_axes if a in axis_sizes)
    if "pod" in axis_sizes and par.pod_fsdp:
        fsdp_axes = ("pod",) + fsdp_axes
    return outer_axis, outer_size, tuple(local_specs), fsdp_axes


def _group_shape(name: str, gdef, par, axis_sizes: Mapping[str, int]):
    """(per-layer local payload elements, FSDP world size, fsdp_axes): what
    the cost model scores."""
    _, _, local_specs, fsdp_axes = _group_axes(name, gdef, par, axis_sizes)
    m = int(np.prod([axis_sizes[a] for a in fsdp_axes])) or 1
    return sum(s.size for s in local_specs), m, fsdp_axes


def _price_entry(cm: CostModel, e: GroupPlanEntry, compute_itemsize: int
                 ) -> float:
    """Predicted per-step comm seconds (both directions) of one resolved
    group under ``cm``; an unsharded group prices 0."""
    if not e.fsdp_axes:
        return 0.0
    elems = sum(s.size for s in e.local_specs)
    n_layers = e.n_layers or 1
    m = e.fsdp_world
    pol = e.policy
    t = cm.gather_time(pol.store, elems, n_layers, m, e.quant_block,
                       compute_itemsize, reshard=pol.reshard_after_forward,
                       mode=pol.gather_mode)
    rmode = ("ring_acc" if pol.reduce_mode == "ring_acc"
             else pol.gather_mode)
    t += cm.reduce_time(pol.reduce_wire, elems, n_layers, m, e.quant_block,
                        compute_itemsize, mode=rmode)
    return t


def _resolve_policies(policies, model, axis_sizes, compute_dtype,
                      cost_model) -> PolicySet:
    if policies is None:
        return PolicySet.from_parallel_config(model.cfg.parallel)
    if isinstance(policies, str):
        if policies == "auto":
            return auto_policies(model, axis_sizes, compute_dtype,
                                 cost_model)
        raise ValueError(
            f"unknown policies spec {policies!r}; expected 'auto', a "
            f"PolicySet, a ShardingPolicy, a CommSchedule, or None")
    if isinstance(policies, PolicySet):
        return policies
    if isinstance(policies, ShardingPolicy):
        return PolicySet(default=policies)
    if isinstance(policies, CommSchedule):
        return PolicySet(default=ShardingPolicy.from_schedule(policies))
    raise ValueError(
        f"unknown policies spec of type {type(policies).__name__}; expected "
        f"'auto', a PolicySet, a ShardingPolicy, a CommSchedule, or None")


def plan(model, axis_sizes: Mapping[str, int], policies=None, *,
         planner: str = "ragged",
         compute_dtype: torch.dtype = torch.bfloat16,
         cost_model: CostModel | None = None) -> ShardingPlan:
    """Resolve ``policies`` (a ``PolicySet``, ``ShardingPolicy``,
    ``CommSchedule``, None for the config's knobs, or ``"auto"``: the
    ``cost_model``'s choices, by default the builtin roofline) against the
    model's communication groups on a mesh given as ``{axis: size}`` into a
    ``ShardingPlan``.  Rules that match no group raise."""
    axis_sizes = {a: int(s) for a, s in axis_sizes.items()}
    cfg = model.cfg
    par = cfg.parallel
    compute_dtype = _torch_dtype(compute_dtype)
    pset = _resolve_policies(policies, model, axis_sizes, compute_dtype,
                             cost_model)
    planner_fn = get_planner(planner)

    entries: dict[str, GroupPlanEntry] = {}
    matched: set[int] = set()
    for name, gdef in model.groups().items():
        info = GroupInfo(name=name, tag=group_tag(name, gdef),
                         n_layers=gdef.n_layers, specs=gdef.specs)
        pol, _ = pset.policy_for(info)
        # a rule shadowed by an earlier one still counts as matched; only
        # a selector that names nothing in this model is an error
        matched.update(i for i, r in enumerate(pset.rules)
                       if r.matches(info))
        sched = pol.to_schedule()
        sched.validate_for(compute_dtype)

        outer_axis, outer_size, local_specs, fsdp_axes = _group_axes(
            name, gdef, par, axis_sizes)
        grad_sync_axes: tuple[str, ...] = ()
        if not sched.sharded:
            # replicated by policy: no gather, gradients all-reduced over
            # the axes the group would have been sharded on
            grad_sync_axes, fsdp_axes = fsdp_axes, ()
        m = int(np.prod([axis_sizes[a] for a in fsdp_axes])) or 1
        store = store_for(pol, cfg.quant_block, m)
        # quant blocks never straddle a shard boundary or a tensor start:
        # for the 8-bit optimizer states, for a quantized store, and for the
        # q8 reduce wire (its reduce-scatter chunks are shard-sized)
        align = max(store.align(),
                    cfg.quant_block if cfg.optimizer == "adam8bit" else 1)
        if planner == "ragged":
            gplan = plan_group(local_specs, m, g_coll=LANE, align=align)
        else:
            gplan = planner_fn(local_specs, m)
        if ((store.quantized or sched.ef_enabled)
                and gplan.shard_size % store.block):
            raise ValueError(
                f"group {name}: planner mode {planner!r} produced shard "
                f"size {gplan.shard_size} not aligned to quant block "
                f"{store.block}; quantized stores and the q8_block reduce "
                f"wire need the ragged planner's align guarantee")
        entries[name] = GroupPlanEntry(
            name=name, tag=info.tag, policy=pol, local_specs=local_specs,
            plan=gplan, fsdp_axes=fsdp_axes,
            fsdp_axis_sizes=tuple(axis_sizes[a] for a in fsdp_axes),
            outer_axis=outer_axis, outer_size=outer_size,
            n_layers=gdef.n_layers, grad_sync_axes=grad_sync_axes,
            quant_block=cfg.quant_block,
            outer_dims={s.name: gdef.outer[s.name].dim
                        for s in gdef.specs if s.name in gdef.outer})

    unmatched = [r.selector() for i, r in enumerate(pset.rules)
                 if i not in matched]
    if unmatched:
        raise ValueError(
            f"policy rules matched no communication group: {unmatched}; "
            f"this model's groups: {sorted(entries)}")
    profile_name, profile_hash = "none", ""
    pricing: dict[str, dict[str, float]] = {}
    if isinstance(policies, str) and policies == "auto":
        # the profile that priced the decisions, and each chosen policy's
        # price under it and under the builtin roofline
        cm = cost_model or CostModel.default()
        prof = cm.provenance_profile()
        profile_name, profile_hash = prof.name, prof.content_hash()
        builtin_cm = CostModel.default()
        isz = compute_dtype.itemsize
        for name, e in entries.items():
            pricing[name] = {
                "auto_ms": round(_price_entry(cm, e, isz) * 1e3, 6),
                "builtin_ms": round(_price_entry(builtin_cm, e, isz) * 1e3,
                                    6),
            }
    return ShardingPlan(base=pset.default, groups=entries,
                        axis_sizes=axis_sizes, planner=planner,
                        compute_dtype=str(compute_dtype).split(".")[-1],
                        profile_name=profile_name,
                        profile_hash=profile_hash, pricing=pricing)
