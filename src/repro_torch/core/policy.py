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

``FSDPRuntime`` takes, by default, the legacy ``ParallelConfig`` knobs
lowered onto a ``PolicySet`` (``PolicySet.from_parallel_config``: a default
policy plus one exact-name rule per ``group_schedules`` entry).
``policies="auto"`` (the reference's ``CostModel`` planner) needs the comm
profiles of ROADMAP Queue 1 item 12 and raises until they are ported; a
plan that no cost model priced carries the profile ``{"name": "none",
"hash": ""}`` and an empty pricing table, as the reference's does.

PARITY: BITWISE -- pure metadata; every resolved plan entry and
``dumps()`` string equals the reference's.
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
from .ragged import LANE, GroupPlan, Placement, TensorSpec, \
    compose_granularity
from .schedule import CommSchedule, resolve_group_schedules
from .store import ParamStore

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
    # priced) and its per-group pricing table -- always unpriced here
    profile_name: str = "none"
    profile_hash: str = ""
    pricing: Mapping[str, Mapping[str, float]] = dataclasses.field(
        default_factory=dict)

    def base_schedule(self) -> CommSchedule:
        return self.base.to_schedule()

    def schedules(self) -> dict[str, CommSchedule]:
        return {n: e.schedule() for n, e in self.groups.items()}

    def gather_wire_bytes(self) -> int:
        return sum(e.gather_wire_bytes(self.compute_dtype)
                   for e in self.groups.values())

    def reduce_wire_bytes(self) -> int:
        return sum(e.reduce_wire_bytes(self.compute_dtype)
                   for e in self.groups.values())

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


def _resolve_policies(policies, model) -> PolicySet:
    if policies is None:
        return PolicySet.from_parallel_config(model.cfg.parallel)
    if isinstance(policies, str):
        if policies == "auto":
            raise NotImplementedError(
                "policies='auto' (the CostModel planner, priced from comm "
                "profiles) is not ported yet (ROADMAP Queue 1 item 12)")
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
         compute_dtype: torch.dtype = torch.bfloat16) -> ShardingPlan:
    """Resolve ``policies`` against the model's communication groups on a
    mesh given as ``{axis: size}`` into a ``ShardingPlan``.  Rules that
    match no group raise."""
    axis_sizes = {a: int(s) for a, s in axis_sizes.items()}
    cfg = model.cfg
    par = cfg.parallel
    pset = _resolve_policies(policies, model)
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
    return ShardingPlan(base=pset.default, groups=entries,
                        axis_sizes=axis_sizes, planner=planner,
                        compute_dtype=str(compute_dtype).split(".")[-1])
