"""ShardingPolicy / ShardingPlan: the planning front-end (port of the
``policies=None`` lowering in ``repro/core/policy.py``).

``FSDPRuntime`` takes, by default, the legacy ``ParallelConfig`` knobs
lowered onto a ``PolicySet`` (``PolicySet.from_parallel_config``: a default
policy plus one exact-name rule per ``group_schedules`` entry) and resolves
it with ``plan()`` into a ``ShardingPlan``: per group the winning policy,
the planner's placements and the mesh-axis decomposition.

The rest of the reference's module -- JSON round trips, ``diff``,
``describe``, the ``CostModel`` and ``policies="auto"`` -- comes with
ROADMAP Queue 1 item 10.

PARITY: BITWISE -- pure metadata; every resolved plan entry (placements,
shard size, padding, axes) equals the reference's.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import glob as _glob
import math
from typing import Mapping, Optional

import numpy as np
import torch

from .planner import get_planner, plan_group
from .ragged import LANE, GroupPlan, TensorSpec, compose_granularity
from .schedule import CommSchedule, resolve_group_schedules
from .store import ParamStore

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


@dataclasses.dataclass(frozen=True)
class GroupInfo:
    """What a PolicyRule selector sees of one communication group."""

    name: str
    tag: str
    n_layers: Optional[int]
    specs: tuple[TensorSpec, ...]


def group_tag(name: str, gdef) -> str:
    if "expert" in name:
        return "experts"
    return "layers" if gdef.n_layers else "globals"


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """Group-name glob + policy (the reference's ``match=`` selector; its
    ``tag=``/``where=`` selectors come with ROADMAP Queue 1 item 10)."""

    policy: ShardingPolicy
    match: str

    def matches(self, info: GroupInfo) -> bool:
        return fnmatch.fnmatchcase(info.name, self.match)

    def selector(self) -> str:
        return f"match={self.match!r}"


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

    def policy_for(self, info: GroupInfo) -> ShardingPolicy:
        for r in self.rules:
            if r.matches(info):
                return r.policy
        return self.default

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


@dataclasses.dataclass(frozen=True)
class GroupPlanEntry:
    """One group's resolved slice of a ShardingPlan."""

    name: str
    tag: str
    policy: ShardingPolicy
    local_specs: tuple[TensorSpec, ...]
    plan: GroupPlan
    fsdp_axes: tuple[str, ...]
    fsdp_axis_sizes: tuple[int, ...]
    n_layers: Optional[int]
    quant_block: int

    @property
    def store(self) -> ParamStore:
        return store_for(self.policy, self.quant_block,
                         math.prod(self.fsdp_axis_sizes) or 1)

    def schedule(self) -> CommSchedule:
        return self.policy.to_schedule()

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
    """The resolved planning artifact the runtime consumes."""

    base: ShardingPolicy
    groups: Mapping[str, GroupPlanEntry]
    axis_sizes: Mapping[str, int]
    planner: str
    compute_dtype: str  # dtype name, e.g. "bfloat16"

    def base_schedule(self) -> CommSchedule:
        return self.base.to_schedule()

    def schedules(self) -> dict[str, CommSchedule]:
        return {n: e.schedule() for n, e in self.groups.items()}


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
                "policies='auto' (the CostModel planner) is not ported yet "
                "(ROADMAP Queue 1 item 10)")
        raise ValueError(
            f"unknown policies spec {policies!r}; expected a PolicySet, a "
            f"ShardingPolicy, a CommSchedule, or None")
    if isinstance(policies, PolicySet):
        return policies
    if isinstance(policies, ShardingPolicy):
        return PolicySet(default=policies)
    if isinstance(policies, CommSchedule):
        return PolicySet(default=ShardingPolicy.from_schedule(policies))
    raise ValueError(
        f"unknown policies spec of type {type(policies).__name__}; expected "
        f"a PolicySet, a ShardingPolicy, a CommSchedule, or None")


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
    get_planner(planner)

    entries: dict[str, GroupPlanEntry] = {}
    matched: set[int] = set()
    for name, gdef in model.groups().items():
        info = GroupInfo(name=name, tag=group_tag(name, gdef),
                         n_layers=gdef.n_layers, specs=gdef.specs)
        pol = pset.policy_for(info)
        matched.update(i for i, r in enumerate(pset.rules)
                       if r.matches(info))
        sched = pol.to_schedule()
        sched.validate_for(compute_dtype)

        _, _, local_specs, fsdp_axes = _group_axes(name, gdef, par,
                                                   axis_sizes)
        m = int(np.prod([axis_sizes[a] for a in fsdp_axes])) or 1
        store = store_for(pol, cfg.quant_block, m)
        # quant blocks never straddle a shard boundary or a tensor start:
        # for the 8-bit optimizer states, for a quantized store, and for the
        # q8 reduce wire (its reduce-scatter chunks are shard-sized)
        align = max(store.align(),
                    cfg.quant_block if cfg.optimizer == "adam8bit" else 1)
        gplan = plan_group(local_specs, m, g_coll=LANE, align=align)
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
            n_layers=gdef.n_layers, quant_block=cfg.quant_block)

    unmatched = [r.selector() for i, r in enumerate(pset.rules)
                 if i not in matched]
    if unmatched:
        raise ValueError(
            f"policy rules matched no communication group: {unmatched}; "
            f"this model's groups: {sorted(entries)}")
    return ShardingPlan(base=pset.default, groups=entries,
                        axis_sizes=axis_sizes, planner=planner,
                        compute_dtype=str(compute_dtype).split(".")[-1])
