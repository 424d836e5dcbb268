"""Plan verification: prove a ShardingPlan's declared invariants against
the traced step before a step runs (port of ``repro/analysis/verify.py``).

The plan declares (``GroupPlanEntry.invariants``,
``ShardingPlan.invariants``) and this module checks, in two layers:

  * ``verify_plan_static(plan)`` -- what needs no trace: each group's
    schedule resolves for the compute dtype, the declared ring chunk's
    block-aligned snap agrees with the snap the wire performs, and a
    priced plan's profile hash still matches the profile on disk (a
    warning).
  * ``verify_runtime(runtime)`` -- traces one train step of a meta twin of
    the runtime (``analysis.trace.trace_train_step``: nothing runs on the
    card) and checks the traced collectives and storages against every
    declared invariant: the wire legs are present and the bytes fit
    integer copies of the plan's ``gather_wire_mb`` and
    ``reduce_wire_mb``, the wire dtypes are legal for the resolved codec,
    ring hops land on the declared snap, the gathered-buffer peak is
    within the layer loop's slot bound, no full-size int8/float8 ->
    float32 decode runs outside a kernel, and the EF residual comes back
    from the step.

Failures are ``Violation``s (group, invariant, expected, found, where)
collected into a ``VerificationReport``; callers raise
(``raise_if_failed``) or print (``summary``).

Three checks read the port's traces, not a jaxpr (``analysis.trace``):

  * ``gathered_peak``: the liveness tooth counts live storages of the
    gathered class over the eager step; the scan-carry tooth has nothing
    to read (an eager step has no carry) and is kept for a trace that
    has carries.
  * ``no_f32_dequant`` reads the trace's conversions.  The reference
    exempts a decode whose value reaches an ``exp`` (the 8-bit Adam
    family's log-space moments, decoded outside its kernel).  The port has
    no such decode outside a kernel -- ``adam8bit_store_update`` decodes
    both moments inside -- so there is no exemption.
  * ``ef_threading`` reads rank 0's state: the residual is m shard-lengths
    a layer, which is the gathered total (the reference's global tree
    holds m x gathered-total a layer, one gathered buffer a device).

PARITY: the same checks, ``checked`` labels (``group:invariant``),
severities, integer-copy bounds and 5% tolerance as the reference's: on
the same plan and trace both give the same report.
"""
from __future__ import annotations

import dataclasses
import math

from ..core.policy import _torch_dtype, dtype_name


# --------------------------------------------------------------------------- #
# report structure
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Violation:
    """One failed invariant: the group, the declared invariant, what the
    plan promised against what the trace (or static check) found, and
    where in the step, when one collective or conversion is at fault."""

    group: str
    invariant: str
    expected: str
    found: str
    where: str = ""
    severity: str = "error"  # "error" | "warning"

    def __str__(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        return (f"[{self.severity}] group={self.group} "
                f"invariant={self.invariant}: expected {self.expected}; "
                f"found {self.found}{loc}")


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """All violations plus the ``group:invariant`` labels that were
    checked (an invariant that never ran is not a pass)."""

    violations: tuple[Violation, ...]
    checked: tuple[str, ...]

    @property
    def errors(self) -> tuple[Violation, ...]:
        return tuple(v for v in self.violations if v.severity == "error")

    @property
    def warnings(self) -> tuple[Violation, ...]:
        return tuple(v for v in self.violations if v.severity == "warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        head = (f"plan verification: {len(self.checked)} invariants "
                f"checked, {len(self.errors)} violations, "
                f"{len(self.warnings)} warnings")
        return "\n".join([head] + [f"  {v}" for v in self.violations])

    def raise_if_failed(self) -> "VerificationReport":
        if not self.ok:
            raise VerificationError(self)
        return self

    def merged(self, other: "VerificationReport") -> "VerificationReport":
        return VerificationReport(self.violations + other.violations,
                                  self.checked + other.checked)


class VerificationError(RuntimeError):
    """Raised by ``raise_if_failed``; carries the whole report."""

    def __init__(self, report: VerificationReport):
        self.report = report
        super().__init__(report.summary())


class _Collector:
    def __init__(self):
        self.violations: list[Violation] = []
        self.checked: list[str] = []

    def check(self, group: str, invariant: str) -> None:
        self.checked.append(f"{group}:{invariant}")

    def fail(self, group: str, invariant: str, expected: str, found: str,
             where: str = "", severity: str = "error") -> None:
        self.violations.append(Violation(group, invariant, expected, found,
                                         where, severity))

    def report(self) -> VerificationReport:
        return VerificationReport(tuple(self.violations),
                                  tuple(self.checked))


# --------------------------------------------------------------------------- #
# static (trace-free) checks
# --------------------------------------------------------------------------- #
def verify_plan_static(plan, *, profile_path=None) -> VerificationReport:
    """Check what the plan alone proves: each group's schedule resolves
    for the compute dtype (``validate_for``), the ring chunk's
    block-aligned snap agrees with the wire's, and -- when
    ``profile_path`` is given or ``BENCH_comm.json`` exists -- a priced
    plan's profile hash matches the profile on disk (a warning: the plan
    runs, its pricing is stale)."""
    col = _Collector()
    cd = _torch_dtype(plan.compute_dtype)
    for name, entry in plan.groups.items():
        col.check(name, "schedule_valid")
        try:
            entry.schedule().validate_for(cd)
        except ValueError as e:
            col.fail(name, "schedule_valid", "schedule resolves for "
                     f"compute={dtype_name(cd)}", str(e))
    for inv in plan.invariants():
        if inv["name"] == "ring_chunk":
            col.check(inv["group"], "ring_chunk")
            if inv["snapped"] != inv["wire"]:
                col.fail(
                    inv["group"], "ring_chunk",
                    f"declared ring_chunk_elems={inv['declared']} snapping "
                    f"to a {inv['unit']}-aligned chunk of {inv['snapped']}",
                    f"wire path snaps to {inv['wire']} "
                    f"({inv['wire'] % inv['unit']} elems past a quant-block "
                    f"boundary: blocks would straddle ring messages)")
        elif inv["name"] == "profile_fresh":
            _check_profile_fresh(col, inv, profile_path)
    return col.report()


def _check_profile_fresh(col: _Collector, inv: dict, profile_path) -> None:
    import os

    from ..core.profile import load_profile

    path = profile_path or "BENCH_comm.json"
    if not os.path.exists(path):
        return
    col.check("*", "profile_fresh")
    try:
        prof = load_profile(path)
    except Exception as e:  # a malformed profile is reported, not raised
        col.fail("*", "profile_fresh", f"loadable profile at {path}",
                 f"{type(e).__name__}: {e}", severity="warning")
        return
    if prof.content_hash() != inv["hash"]:
        col.fail(
            "*", "profile_fresh",
            f"plan priced with profile {inv['profile']}@{inv['hash']}",
            f"profile on disk ({path}) now hashes "
            f"{prof.content_hash()} -- pricing is stale, re-plan to "
            f"re-price", severity="warning")


# --------------------------------------------------------------------------- #
# trace-backed checks
# --------------------------------------------------------------------------- #
def _axes_of(entry) -> frozenset:
    return frozenset(entry.fsdp_axes)


def _event_matches_group(ev, entry, legs, rdtypes) -> bool:
    """Attribute a collective to a plan group by its signature: it runs
    over the group's FSDP axes (ring hops by the group's size alone, as
    the reference's ring axis is a collapsed name) and its payload is one
    of the group's wire legs (the whole leg for a one-shot collective, a
    divisor chunk for a ring hop)."""
    shard = entry.plan.shard_size
    total = entry.plan.total
    if ev.kind == "all_gather":
        return (_axes_of(entry) == frozenset(ev.axes)
                and any(ev.elems == e for _, e in legs))
    if ev.kind in ("psum_scatter", "reduce_scatter"):
        return (_axes_of(entry) == frozenset(ev.axes)
                and ev.dtype in rdtypes and ev.elems == total)
    if ev.kind == "ppermute":
        if ev.axis_size != entry.fsdp_world:
            return False
        for d, e in legs:
            if ev.dtype == d and e % max(ev.elems, 1) == 0:
                return True
        for d in rdtypes:
            # ring_acc and q8 routes chunk the shard; the order-exact route
            # carries multiples of the shard chunk
            if ev.dtype == d and (shard % max(ev.elems, 1) == 0
                                  or ev.elems % max(shard, 1) == 0):
                return True
        return False
    return False


def _byte_fit(observed: float, unit_g: float, unit_r: float,
              a_max: int, b_max: int) -> tuple[int, int, float]:
    """The best integers (a, b) with observed ~= a*unit_g + b*unit_r and
    their relative error: per-layer copy counts (forward, remat
    re-gathers, reduces), so small integers."""
    best = (0, 0, 1.0 if observed else 0.0)
    for a in range(a_max + 1):
        rem = observed - a * unit_g
        if unit_r > 0:
            b = max(0, min(b_max, int(round(rem / unit_r))))
        else:
            b = 0
        got = a * unit_g + b * unit_r
        err = abs(observed - got) / max(observed, 1.0)
        if err < best[2]:
            best = (a, b, err)
    return best


def verify_trace(plan, comm, buffers, out_shapes=None, *,
                 rtol: float = 0.05) -> VerificationReport:
    """Check a plan's declared invariants against a ``CommTrace`` and a
    ``BufferTrace`` (and, for EF threading, the step's output as
    ``LeafSpec``s).  A pure function of the traces; ``verify_runtime``
    traces and adds the static pass."""
    col = _Collector()
    cd = _torch_dtype(plan.compute_dtype)
    by_group: dict[str, list[dict]] = {}
    for inv in plan.invariants():
        by_group.setdefault(inv["group"], []).append(inv)

    for name, entry in plan.groups.items():
        declared = {i["name"]: i for i in by_group.get(name, ())}
        if "comm_bytes" in declared:
            _check_comm(col, entry, declared["comm_bytes"],
                        declared.get("ring_chunk"), comm, rtol)
        if "wire_dtype" in declared:
            _check_wire_dtype(col, entry, declared["wire_dtype"], comm)
        if "no_f32_dequant" in declared:
            _check_no_f32_dequant(col, entry, declared["no_f32_dequant"],
                                  buffers)
        if "ef_threading" in declared:
            _check_ef_threading(col, entry, out_shapes)

    for inv in by_group.get("*", ()):
        if inv["name"] == "gathered_peak":
            _check_gathered_peak(col, inv, cd, buffers)
    return col.report()


def _check_comm(col, entry, inv, ring_inv, comm, rtol) -> None:
    """``comm_missing`` and ``comm_bytes``: every declared wire leg appears
    with the right collective kind, and the traced wire bytes attributed
    to the group fit an integer number of the plan's per-copy predictions
    (scaled by the (m-1)/m discount the plan's accounting leaves out)."""
    name = entry.name
    m = entry.fsdp_world
    legs = tuple((d, int(e)) for d, e in inv["gather_legs"])
    rdtypes = tuple(inv["reduce_dtypes"])
    mine = [e for e in comm.events
            if _event_matches_group(e, entry, legs, rdtypes)]

    col.check(name, "comm_missing")
    ring_gather = (ring_inv is not None
                   and entry.schedule().gather_mode == "ring")
    gather_kinds = ("ppermute",) if ring_gather else ("all_gather",)
    for d, e in legs:
        hit = [ev for ev in mine if ev.kind in gather_kinds
               and ev.dtype == d
               and (e % max(ev.elems, 1) == 0 if ring_gather
                    else ev.elems == e)]
        if not hit:
            near = sorted({(ev.kind, ev.dtype, ev.elems) for ev in mine})
            col.fail(name, "comm_missing",
                     f"gather leg {d}[{e}] via {gather_kinds[0]} "
                     f"(codec {entry.policy.store})",
                     f"no matching collective; group-attributed events: "
                     f"{near or 'none'}")
    reduce_kinds = (("ppermute",) if inv["reduce_route"] == "ring"
                    else ("psum_scatter", "reduce_scatter"))
    rhit = [ev for ev in mine if ev.kind in reduce_kinds
            and ev.dtype in rdtypes]
    if not rhit:
        near = sorted({(ev.kind, ev.dtype, ev.elems) for ev in mine})
        col.fail(name, "comm_missing",
                 f"reduce route {inv['reduce_route']} in {rdtypes}",
                 f"no matching collective; group-attributed events: "
                 f"{near or 'none'}")

    col.check(name, "comm_bytes")
    observed = sum(e.wire_bytes * e.trips for e in mine)
    n = entry.n_layers or 1
    disc = (m - 1) / m if m > 1 else 0.0
    unit_g = inv["gather_mb_per_copy"] * 1e6 * disc
    unit_r = inv["reduce_mb_per_copy"] * 1e6 * disc
    a, b, err = _byte_fit(observed, unit_g, unit_r,
                          a_max=4 * n + 8, b_max=2 * n + 4)
    if err > rtol:
        col.fail(name, "comm_bytes",
                 f"traced wire bytes = a*{unit_g / 1e6:.4f}MB + "
                 f"b*{unit_r / 1e6:.4f}MB (integer copies of the plan's "
                 f"per-copy predictions)",
                 f"{observed / 1e6:.4f}MB; best fit a={a} b={b} off by "
                 f"{100 * err:.1f}% (> {100 * rtol:.0f}% tolerance)")

    if ring_inv is not None:
        _check_ring_chunk_trace(col, entry, ring_inv, mine, legs)


def _check_ring_chunk_trace(col, entry, inv, mine, legs) -> None:
    """Traced ring hops land on the declared snap: code chunks stay
    quant-block aligned, and a ring gather's primary leg moves in chunks
    of the declared snapped size."""
    name, unit = entry.name, inv["unit"]
    col.check(name, "ring_chunk")
    code_dtype, code_elems = legs[0]
    hops = [e for e in mine if e.kind == "ppermute" and e.dtype == code_dtype
            and code_elems % max(e.elems, 1) == 0]
    misaligned = sorted({e.elems for e in hops if e.elems % unit})
    if misaligned:
        col.fail(name, "ring_chunk",
                 f"every {code_dtype} ring hop a multiple of the quant "
                 f"block ({unit})",
                 f"hop chunks {misaligned} straddle block boundaries",
                 where=next(e.path for e in hops if e.elems % unit))
    if (entry.schedule().gather_mode == "ring" and hops
            and not any(e.elems == inv["snapped"] for e in hops)):
        col.fail(name, "ring_chunk",
                 f"gather ring hops of the snapped chunk size "
                 f"{inv['snapped']} (declared {inv['declared']})",
                 f"observed hop sizes {sorted({e.elems for e in hops})}")


def _check_wire_dtype(col, entry, inv, comm) -> None:
    """A collective shaped like this group's shard or gathered buffer over
    its axes ships a dtype the resolved codec allows: a plan promising q8
    while the step ships bf16 (or the reverse) fails here."""
    name = entry.name
    col.check(name, "wire_dtype")
    legal = set(inv["legal"])
    shard, total = entry.plan.shard_size, entry.plan.total
    for ev in comm.events:
        if ev.kind == "ppermute":
            if ev.axis_size != entry.fsdp_world:
                continue
            sized = (shard % max(ev.elems, 1) == 0
                     or ev.elems % max(shard, 1) == 0)
        else:
            if frozenset(ev.axes) != _axes_of(entry):
                continue
            sized = ev.elems in (shard, total)
        # scales ride beside the codes at block granularity
        sized = sized or (entry.store.quantized
                          and (shard // entry.quant_block)
                          % max(ev.elems, 1) == 0)
        if sized and ev.dtype not in legal:
            col.fail(name, "wire_dtype",
                     f"wire dtypes within {sorted(legal)} (resolved codec "
                     f"{entry.policy.store}/"
                     f"{entry.policy.reduce_wire or 'cast'})",
                     f"{ev.kind} ships {ev.dtype}[{ev.elems}]",
                     where=ev.path)


def _check_no_f32_dequant(col, entry, inv, buffers) -> None:
    """A quantized gather decodes straight into the compute dtype: no
    full-gathered-size code -> float32 conversion outside a kernel.  The
    invariant's ``src_dtype`` names the code dtype ("int8" for q8_block,
    the float8 dtype for an fp8 store).  No exemption (the module
    docstring)."""
    name = entry.name
    col.check(name, "no_f32_dequant")
    gathered = inv["gathered_elems"]
    src_dtype = inv.get("src_dtype", "int8")
    for c in buffers.full_f32(gathered, src_dtype):
        col.fail(name, "no_f32_dequant",
                 "quantized decode fused into the compute dtype (no "
                 f"full-size {src_dtype}->float32 materialization)",
                 f"conversion {src_dtype}->float32 over {c.elems} elems "
                 f"(gathered size {gathered})", where=c.path)


def _check_ef_threading(col, entry, out_shapes) -> None:
    """The EF residual comes back from the step as an fp32 leaf under the
    group's ``reduce_ef`` key in the new-params tree, of m shard-lengths
    (the gathered total) a layer on rank 0 (the module docstring)."""
    from ..core.store import EF_KEY

    name = entry.name
    col.check(name, "ef_threading")
    if out_shapes is None:
        return
    new_params = out_shapes[0]
    g = new_params.get(name) if isinstance(new_params, dict) else None
    leaf = g.get(EF_KEY) if isinstance(g, dict) else None
    expect = entry.fsdp_world * entry.plan.shard_size
    if leaf is None:
        col.fail(name, "ef_threading",
                 f"'{EF_KEY}' residual leaf in the step's new-params tree",
                 f"group output keys: "
                 f"{sorted(g) if isinstance(g, dict) else type(g).__name__}")
        return
    n = math.prod(leaf.shape) if leaf.shape else 1
    per_layer = n // (entry.n_layers or 1) if entry.n_layers else n
    if dtype_name(leaf.dtype) != "float32" or per_layer != expect:
        col.fail(name, "ef_threading",
                 f"fp32 residual of m shard-lengths = {expect} "
                 f"elems/layer on rank 0",
                 f"{dtype_name(leaf.dtype)}"
                 f"[{'x'.join(map(str, leaf.shape))}]")


def _check_gathered_peak(col, inv, cd, buffers) -> None:
    """Two teeth: no scan carry holds a gathered layer buffer in the
    compute dtype, and the liveness peak of gathered-size compute-dtype
    storages stays within ``2 x slots + 1`` (a cotangent twin a live
    gathered buffer in backward, and one alias)."""
    slots = inv["max_slots"]
    cdn = dtype_name(cd)
    for gname, meta in inv["groups"].items():
        elems = meta["elems"]
        col.check(gname, "gathered_peak")
        carried = [s for s, d in buffers.scan_carries
                   if d == cdn and math.prod(s) == elems]
        if carried:
            col.fail(gname, "gathered_peak",
                     f"no {cdn}[{elems}] gathered buffer in any scan "
                     f"carry (reshard-after-forward frees layers)",
                     f"scan carries hold {carried}")
        peak = buffers.live_peak(elems=elems, dtype=cd)
        bound = 2 * slots + 1
        if peak > bound:
            col.fail(gname, "gathered_peak",
                     f"<= {bound} simultaneously-live {cdn}[{elems}] "
                     f"buffers (2x {slots} slots for backward cotangents, "
                     f"+1 aliasing view)",
                     f"liveness peak {peak}")


# --------------------------------------------------------------------------- #
# entry point
# --------------------------------------------------------------------------- #
def verify_runtime(runtime, optimizer=None, *, batch=None, plan=None,
                   profile_path=None, rtol: float = 0.05
                   ) -> VerificationReport:
    """Trace one train step of a meta twin of ``runtime``
    (``trace_train_step``) and check every invariant its plan declares,
    the static checks included.  ``plan`` defaults to the runtime's own;
    another plan verifies THAT plan's promises against THIS runtime's
    step (the broken-plan demos)."""
    from .trace import trace_train_step

    plan = plan if plan is not None else runtime.plan
    report = verify_plan_static(plan, profile_path=profile_path)
    trace = trace_train_step(runtime, optimizer, batch=batch)
    return report.merged(verify_trace(plan, trace.comm, trace.buffers,
                                      trace.out_shapes, rtol=rtol))
