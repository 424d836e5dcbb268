"""Structure-aware planning for grouped RaggedShard tensors (paper §5,
Alg. 1; port of ``repro/core/planner.py``).

Given tensors t with sizes e_t and block granularities g_t, choose a uniform
per-rank buffer size S and contiguous intervals [l_t, r_t) in the global
buffer (size m*S) minimizing S subject to contiguous tensor memory,
non-sharded blocks and balanced load.  Candidate shard sizes are multiples
of LCMs over prefixes of the sorted granularities (seeded with g_coll);
for a fixed S, tensors are placed in order at their earliest feasible
offset, and feasibility is monotone in k for S = k*g, so k is
binary-searched.

Pure integer work: plans are BITWISE the reference's (same placements,
shard size and padding).  The baseline planners (fsdp2, megatron, naive)
come with ROADMAP Queue 1 item 10.
"""
from __future__ import annotations

import math
from typing import Sequence

from .ragged import LANE, GroupPlan, Placement, TensorSpec

# max boundaries probed for the one-interior-boundary case before declaring
# it infeasible; residues of boundaries mod g cycle with period g/gcd(S, g).
_MAX_BOUNDARY_PROBES = 4096


def _earliest_start(pos: int, e: int, g: int, S: int,
                    align: int = 1) -> int | None:
    """Smallest l >= pos where a tensor (size e, block g) can start, given
    shard size S, such that no shard boundary splits a block; ``align``
    additionally rounds starts up to a multiple."""
    cands: list[int] = []

    def up(x: int, a: int) -> int:
        return -(-x // a) * a

    # case (1): entirely inside one shard -> no block-alignment constraint.
    if e <= S:
        l = up(pos, align)
        if (l % S) + e > S:
            l = up(l // S * S + S, align)
        cands.append(l)

    # case (3): S is a multiple of g -> any g-aligned start works.
    if S % g == 0:
        cands.append(up(pos, math.lcm(g, align)))

    # case (2): exactly one boundary b strictly inside; need l = b (mod g).
    if e <= 2 * S:
        probes = (
            1
            if S % g == 0
            else min(g // math.gcd(S, g) + 1, _MAX_BOUNDARY_PROBES)
        )
        b = (pos // S + 1) * S
        found = None
        for _ in range(probes):
            lo = max(pos, b - S, b - e + 1)
            hi = min(b - 1, b + S - e)
            if lo <= hi:
                l = lo + (b - lo) % g
                if align > 1:
                    while l <= hi and l % align != 0:
                        l += g
                if l <= hi:
                    found = l
                    break
            b += S
        if found is not None:
            cands.append(found)

    return min(cands) if cands else None


def _place_all(tensors: Sequence[TensorSpec], S: int,
               align: int = 1) -> list[Placement] | None:
    """Greedy earliest-feasible placement; None if some tensor can't start."""
    pos = 0
    out: list[Placement] = []
    for t in tensors:
        l = _earliest_start(pos, t.size, t.granularity, S, align)
        if l is None:
            return None
        out.append(Placement(t, l))
        pos = l + t.size
    return out


def check_valid_shard(tensors: Sequence[TensorSpec], S: int, m: int,
                      align: int = 1) -> bool:
    """The paper's CheckValidShard: can everything fit in m shards of S?"""
    placed = _place_all(tensors, S, align)
    return placed is not None and (placed[-1].end if placed else 0) <= m * S


def _min_feasible_k(tensors, g: int, m: int, total: int, max_g: int,
                    align: int = 1) -> int | None:
    """Smallest k with S=k*g feasible (feasibility monotone in k)."""
    k_lo = max(1, -(-total // (m * g)), -(-max_g // g))
    k = k_lo
    for _ in range(64):
        if check_valid_shard(tensors, k * g, m, align):
            break
        k *= 2
    else:
        return None
    hi, lo = k, max(k_lo, k // 2)
    while lo < hi:
        mid = (lo + hi) // 2
        if check_valid_shard(tensors, mid * g, m, align):
            hi = mid
        else:
            lo = mid + 1
    return hi


def plan_group(tensors: Sequence[TensorSpec], num_shards: int, *,
               g_coll: int = LANE, order: str = "default",
               align: int = 1) -> GroupPlan:
    """Algorithm 1.  ``order`` in {default, by_granularity, by_size}."""
    if not tensors:
        return GroupPlan((), shard_size=g_coll, num_shards=num_shards)
    g_coll = math.lcm(g_coll, align)
    tensors = list(tensors)
    if order == "by_granularity":
        tensors.sort(key=lambda t: t.granularity)
    elif order == "by_size":
        tensors.sort(key=lambda t: t.size, reverse=True)
    elif order != "default":
        raise ValueError(order)

    m = num_shards
    total = sum(t.size for t in tensors)
    max_g = max(t.granularity for t in tensors)

    best_S: int | None = None
    g = g_coll
    grans = sorted({t.granularity for t in tensors})
    for g_next in [None] + grans:
        if g_next is not None:
            g = math.lcm(g, g_next)
        if best_S is not None and g > best_S:
            continue
        k = _min_feasible_k(tensors, g, m, total, max_g, align)
        if k is not None and (best_S is None or k * g < best_S):
            best_S = k * g
    if best_S is None:
        raise ValueError("planner: no feasible shard size found")

    placements = _place_all(tensors, best_S, align)
    if placements is None:
        raise RuntimeError(
            f"planner: shard size {best_S} was judged feasible but "
            f"placement failed -- feasibility probe and placer disagree")
    plan = GroupPlan(tuple(placements), shard_size=best_S, num_shards=m)
    plan.validate()
    return plan


def get_planner(mode: str):
    """Planner lookup: only Algorithm 1 is ported."""
    if mode == "ragged":
        return plan_group
    if mode in ("fsdp2", "megatron", "naive"):
        raise NotImplementedError(
            f"planner {mode!r} is not ported yet (ROADMAP Queue 1 item 10)")
    raise ValueError(
        f"unknown planner mode {mode!r}; expected one of "
        f"['fsdp2', 'megatron', 'naive', 'ragged']")
