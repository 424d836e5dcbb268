"""CommProfile: versioned, schema-checked communication calibration
profiles (port of ``repro/core/profile.py``, schema ``comm-profile/v1``).

``launch/bench_comm.py`` times each wire codec x gather/reduce route x
ring chunk over a process group and saves a ``CommProfile``;
``CostModel.from_profile`` (``core.policy``) fits latency/bandwidth lines
over its entries, prices the store formats and wires of
``policies="auto"`` from them and picks each ring group's
``ring_chunk_elems`` (``best_ring_chunk``).  Every auto-priced
``ShardingPlan`` records the profile's ``name`` and ``content_hash()``.

Without a measured profile the cost model prices with the closed-form
roofline over the ``launch/mesh.py`` constants; ``builtin_profile()``
renders them as a profile named ``builtin-roofline`` (``builtin=True``,
two exact points per curve), so a plan's provenance is never empty.  A
measured profile is end to end (``end_to_end=True``): its q8 entries
include the encode and decode, so no analytic HBM term is added on top.

Schema (``comm-profile/v1``)::

    {"schema": "comm-profile/v1",
     "name": "measured-cuda-1dev",       # or "builtin-roofline"
     "builtin": false, "end_to_end": true,
     "backend": "cuda", "world": 1, "quick": true,
     "entries": [{"direction": "gather",  # gather | reduce
                  "fmt": "fp32",          # a core.wire WIRE_FORMATS name
                  "mode": "xla",          # xla | ring | ring_acc
                  "elems": 65536,         # full logical buffer elements
                  "chunk_elems": 65536,   # ring message size (== elems:
                                          #   the shard-sized default)
                  "time_us": 123.4}, ...]}

``python -m repro_torch.core.profile <path>`` validates a file.

PARITY: BITWISE -- pure Python float arithmetic in the reference's order;
``content_hash`` of the same samples equals the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Mapping, Optional

SCHEMA = "comm-profile/v1"

DIRECTIONS = ("gather", "reduce")
# "xla" = the XLA collective (all_gather / psum_scatter); "ring" = the
# manual ppermute ring routes (order-exact reduce in ring gather mode);
# "ring_acc" = the accumulate-in-flight reduce ring (reduce only).
MODES = ("xla", "ring", "ring_acc")

BUILTIN_NAME = "builtin-roofline"

# the legacy CostModel per-collective issue latency (seconds); the builtin
# profile is synthesized from this + the launch/mesh.py bandwidth constants
BUILTIN_LATENCY_S = 5e-6


@dataclasses.dataclass(frozen=True)
class CommSample:
    """One measured (or synthesized) point on a comm curve."""

    direction: str   # gather | reduce
    fmt: str         # wire format name (core.wire.WIRE_FORMATS)
    mode: str        # xla | ring | ring_acc
    elems: int       # full logical buffer elements
    chunk_elems: int  # ring message elements (== elems: shard-sized)
    time_us: float

    def key(self) -> tuple[str, str, str]:
        return (self.direction, self.fmt, self.mode)

    def to_json(self) -> dict:
        return {"direction": self.direction, "fmt": self.fmt,
                "mode": self.mode, "elems": int(self.elems),
                "chunk_elems": int(self.chunk_elems),
                "time_us": float(self.time_us)}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"invalid comm profile: {msg}")


@dataclasses.dataclass(frozen=True)
class CommProfile:
    """A versioned set of comm measurements plus fitted curves.

    ``linear(direction, fmt, mode)`` fits ``time_s = latency + elems *
    per_elem_s`` over the key's shard-sized-chunk entries (non-negative
    least squares via clamping); ``best_ring_chunk`` searches the chunk
    sweep.  Frozen + hashable so it can ride ``CostModel`` (also frozen).
    """

    name: str
    entries: tuple[CommSample, ...]
    backend: str = "cpu"
    world: int = 1           # devices the collectives ran over
    builtin: bool = False    # synthesized from the roofline constants
    end_to_end: bool = True  # entries include codec encode/decode cost
    quick: bool = False

    def __post_init__(self):
        _check(bool(self.name), "empty profile name")
        _check(bool(self.entries), "no entries")
        _check(self.world >= 1, f"world {self.world} < 1")
        for s in self.entries:
            _check(s.direction in DIRECTIONS,
                   f"direction {s.direction!r} not in {DIRECTIONS}")
            _check(s.mode in MODES, f"mode {s.mode!r} not in {MODES}")
            _check(not (s.direction == "gather" and s.mode == "ring_acc"),
                   "ring_acc is a reduce-only mode")
            _check(isinstance(s.fmt, str) and bool(s.fmt),
                   f"bad fmt {s.fmt!r}")
            _check(s.elems >= 1, f"elems {s.elems} < 1")
            _check(1 <= s.chunk_elems <= s.elems,
                   f"chunk_elems {s.chunk_elems} outside [1, {s.elems}]")
            _check(s.time_us >= 0, f"negative time_us {s.time_us}")

    # ------------------------------------------------------------------ #
    # serialization
    # ------------------------------------------------------------------ #
    def to_json(self) -> dict:
        return {
            "schema": SCHEMA,
            "name": self.name,
            "backend": self.backend,
            "world": int(self.world),
            "builtin": bool(self.builtin),
            "end_to_end": bool(self.end_to_end),
            "quick": bool(self.quick),
            "entries": [s.to_json() for s in self.entries],
        }

    def dumps(self) -> str:
        """Canonical JSON (sorted keys) -- ``content_hash`` hashes this."""
        return json.dumps(self.to_json(), sort_keys=True)

    def content_hash(self) -> str:
        """Short stable content hash; recorded by every plan this profile
        priced, so replanning can prove it used the same measurements."""
        return hashlib.sha256(self.dumps().encode()).hexdigest()[:12]

    @classmethod
    def from_json(cls, data: Mapping[str, Any]) -> "CommProfile":
        _check(isinstance(data, Mapping), f"not an object: {type(data)}")
        _check(data.get("schema") == SCHEMA,
               f"schema {data.get('schema')!r} != {SCHEMA!r}")
        for k in ("name", "entries"):
            _check(k in data, f"missing key {k!r}")
        raw = data["entries"]
        _check(isinstance(raw, (list, tuple)), "entries is not a list")
        entries = []
        for i, e in enumerate(raw):
            _check(isinstance(e, Mapping), f"entries[{i}] is not an object")
            missing = {"direction", "fmt", "mode", "elems", "chunk_elems",
                       "time_us"} - set(e)
            _check(not missing, f"entries[{i}] missing {sorted(missing)}")
            entries.append(CommSample(
                direction=str(e["direction"]), fmt=str(e["fmt"]),
                mode=str(e["mode"]), elems=int(e["elems"]),
                chunk_elems=int(e["chunk_elems"]),
                time_us=float(e["time_us"])))
        return cls(name=str(data["name"]), entries=tuple(entries),
                   backend=str(data.get("backend", "unknown")),
                   world=int(data.get("world", 1)),
                   builtin=bool(data.get("builtin", False)),
                   end_to_end=bool(data.get("end_to_end", True)),
                   quick=bool(data.get("quick", False)))

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    # ------------------------------------------------------------------ #
    # fitted curves
    # ------------------------------------------------------------------ #
    def has(self, direction: str, fmt: str, mode: str) -> bool:
        return any(s.key() == (direction, fmt, mode) for s in self.entries)

    def linear(self, direction: str, fmt: str, mode: str
               ) -> tuple[float, float]:
        """``(latency_s, per_elem_s)`` least-squares fit of the key's
        shard-sized-chunk entries (``chunk_elems == elems``), clamped to
        non-negative.  One point degenerates to a pure-slope model; a
        missing key raises (callers gate on ``has``)."""
        pts = [(s.elems, s.time_us * 1e-6) for s in self.entries
               if s.key() == (direction, fmt, mode)
               and s.chunk_elems == s.elems]
        if not pts:  # chunk-sweep-only key: fall back to its best chunk
            pts = [(s.elems, s.time_us * 1e-6) for s in self.entries
                   if s.key() == (direction, fmt, mode)]
        if not pts:
            raise KeyError(f"no profile entries for "
                           f"({direction}, {fmt}, {mode})")
        if len(pts) == 1 or len({x for x, _ in pts}) == 1:
            x, t = pts[0]
            return 0.0, max(t / x, 0.0)
        n = float(len(pts))
        sx = sum(x for x, _ in pts)
        st = sum(t for _, t in pts)
        sxx = sum(x * x for x, _ in pts)
        sxt = sum(x * t for x, t in pts)
        denom = n * sxx - sx * sx
        slope = (n * sxt - sx * st) / denom
        lat = (st - slope * sx) / n
        if slope < 0:  # noisy micro-bench: fall back to mean per-elem time
            return 0.0, max(st / sx, 0.0)
        return max(lat, 0.0), slope

    def time_s(self, direction: str, fmt: str, mode: str,
               elems: float) -> float:
        lat, slope = self.linear(direction, fmt, mode)
        return lat + elems * slope

    def best_ring_chunk(self, direction: str, fmt: str) -> Optional[int]:
        """The chunk size (elems per ring message) with the lowest
        normalized time across the key's ring-mode chunk sweep, or None
        when the profile has no sweep (or the shard-sized default wins).
        The autotuner snaps this to a divisor of the actual shard size
        (core.wire's chunk rule), so any positive answer is safe."""
        modes = ("ring",) if direction == "gather" else ("ring", "ring_acc")
        sweep: dict[int, list[float]] = {}
        default: dict[int, list[float]] = {}
        for s in self.entries:
            if s.direction != direction or s.fmt != fmt or s.mode not in modes:
                continue
            bucket = default if s.chunk_elems == s.elems else sweep
            bucket.setdefault(s.chunk_elems, []).append(
                s.time_us * 1e-6 / s.elems)
        if not sweep:
            return None
        norm = lambda v: sum(v) / len(v)
        best_chunk, best_t = min(
            ((c, norm(v)) for c, v in sweep.items()), key=lambda kv: kv[1])
        base = min((norm(v) for v in default.values()), default=None)
        if base is not None and base <= best_t:
            return None  # shard-sized default already wins
        return int(best_chunk)


# --------------------------------------------------------------------------- #
# the builtin fallback profile
# --------------------------------------------------------------------------- #
def builtin_profile(ici_bw: Optional[float] = None,
                    latency_s: float = BUILTIN_LATENCY_S) -> CommProfile:
    """The ``launch/mesh.py`` roofline constants rendered as a profile:
    two exact points per (direction, fmt, mode) curve, so the linear fit
    recovers ``latency_s`` + ``wire_bytes/ici_bw`` bit-for-bit.  Tagged
    ``builtin=True`` -- the cost model prices builtin profiles through the
    closed-form roofline (with the group's real quant block), and uses the
    fitted curves only for *measured* profiles."""
    if ici_bw is None:
        from ..launch import mesh

        ici_bw = mesh.ICI_BW
    # synthesized wire bytes/elem at the default 1024 quant block; the
    # closed-form pricing uses each group's actual block, so these entries
    # are documentation and hash material, not the pricing path.  The fp8
    # wires (1 B/elem, no scales) come from quant.fp8, in the reference's
    # order (e4m3, e5m2).
    from ..quant.fp8 import FP8_DTYPES

    bytes_per_elem = {"fp32": 4.0, "bf16": 2.0, "q8_block": 1.0 + 4.0 / 1024,
                      **{name: 1.0 for name in FP8_DTYPES}}
    entries = []
    for direction in DIRECTIONS:
        for mode in MODES:
            if direction == "gather" and mode == "ring_acc":
                continue
            for fmt, bpe in bytes_per_elem.items():
                for elems in (1 << 20, 1 << 24):
                    t = latency_s + elems * bpe / ici_bw
                    entries.append(CommSample(
                        direction=direction, fmt=fmt, mode=mode,
                        elems=elems, chunk_elems=elems,
                        time_us=t * 1e6))
    return CommProfile(name=BUILTIN_NAME, entries=tuple(entries),
                       backend="roofline", world=1, builtin=True,
                       end_to_end=False, quick=False)


def load_profile(path) -> CommProfile:
    """Load and schema-check a profile from any path."""
    with open(path) as f:
        data = json.load(f)
    return CommProfile.from_json(data)


def main(argv=None) -> int:
    """``python -m repro_torch.core.profile <path>``: exit 0 and print a
    summary iff the file is a valid comm-profile/v1."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("path", help="profile JSON to validate")
    args = ap.parse_args(argv)
    try:
        prof = load_profile(args.path)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"INVALID {args.path}: {e}")
        return 1
    keys = sorted({s.key() for s in prof.entries})
    sweeps = sum(1 for s in prof.entries if s.chunk_elems != s.elems)
    print(f"OK {args.path}: name={prof.name} hash={prof.content_hash()} "
          f"backend={prof.backend} world={prof.world} "
          f"entries={len(prof.entries)} curves={len(keys)} "
          f"chunk_sweep_points={sweeps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
