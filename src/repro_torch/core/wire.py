"""WireCodec and the ZeRO-3 gather/reduce-scatter pair (port of
``repro/core/wire.py``: the cast codecs, fp8 among them, the ``q8_block``
codec, the match-mode reduce-scatter and the error-feedback gathers).

  * ``WireCodec`` -- one payload format on the wire.  Cast codecs
    (``fp32``, ``bf16``, ``fp8_e4m3``, ``fp8_e5m2``): the payload is the
    buffer itself in that dtype; ``encode``/``decode`` are casts, the fp8
    encode being ``quant.fp8.fp8_encode`` (the reference's overflow rule,
    not a library cast).  ``q8_block``: the payload is ``{"codes": int8,
    "scales": fp32 per block}``, encoded by ``kernels.ops.quantize`` and
    decoded by ``ops.dequantize_into``.
  * ``payload_all_gather`` -- pure data movement of a flat shard:
    ``all_gather_into_tensor`` (``mode="xla"``, optionally asynchronous,
    which the prefetch schedule uses to issue two gathers before either
    layer's compute) or the ring (``mode="ring"``): n-1 point-to-point
    hops over ``batch_isend_irecv``, each forwarding the shard just
    received to the left neighbour, written into the output at absolute
    rank offsets.
  * ``codec_reduce_scatter`` -- the gradient reduce-combine rule, per
    reduce codec and route (``dtype_reduce_scatter`` for the cast codecs):
      - xla / match: fp32 and bf16 reduce-scatter with SUM in the codec
        dtype (the backend's order).  An fp8 codec routes each
        destination's codes to it un-reduced (``all_to_all_single`` of
        uint8 views: collectives take no float8) and sums its n
        contributions as XLA:CPU's ``psum_scatter`` does on fp8 payloads
        (in float16, from +0, in rank order) and encodes the sum once.
      - ring / match: chunks routed un-reduced to their destinations by
        ring hops (hop k carries n-1-k chunks), summed there in fp32 in
        absolute rank order and rounded once to the codec dtype.
      - ring_acc: one partial sum per destination rides the ring, every
        hop adding the local contribution in the codec dtype: n-1
        chunk-hops, in ring order.
      - q8_block: the cotangent is encoded once (with error feedback
        through ``ops.encode_ef``); match mode routes codes and scales
        un-reduced (``all_to_all_single``, or ring hops in ring mode) and
        the destination dequantizes and sums in fp32 in rank order;
        ring_acc carries the partial sum quantized, each hop dequantizing,
        adding and requantizing (``ops.quantize``/``ops.dequantize`` at
        chunk shapes).
    ``ring_chunk`` (``CommSchedule.ring_chunk_elems``) splits every ring
    message into equal sub-chunks run as independent rings
    (``_snap_chunk``); every element keeps its contributions and their
    order, so it is bitwise-neutral within each route.
  * ``codec_gather``, ``q8_gather``, ``fp8_gather`` -- one
    ``torch.autograd.Function``: forward is the gather (a flat store
    casts its shard to the wire dtype, gathers and casts to the compute
    dtype; the q8 and fp8 stores gather their stored payload and decode
    it); backward is ``codec_reduce_scatter`` of the cotangent into the
    gradient buffer it was handed, straight to the fp32 master for the
    coded stores, and with a residual ``ef`` it also writes the new
    residual into ``ef``.  The reference adds ``codec_grad_proxy``'s zeros
    to a decoded payload; that adds +0.0, which changes nothing but the
    sign of a zero (a q8 value is never -0.0; an fp8 code of -0.0 decodes
    to -0.0 here and +0.0 there), so the port skips the add.  Each takes
    an optional ``started`` gather (``start_*``), whose result its
    forward waits for instead of gathering.

A ``group`` of None stands for a group with no FSDP axes (an unsharded
one): no collective runs, as in the reference with empty ``axes``.  With
no peers (n = 1) the ring routes return the reference's n = 1 result.

With gradient accumulation a gather can defer its error feedback
(``defer``): its backward adds the fp32 cotangent to an accumulator and
the runtime reduce-scatters the sum once at the accumulation boundary
(the reference's ``*_defer_ef`` primitives: one encode per step, never
one per microbatch).

PARITY: the casts, encodes and decodes are op-for-op the reference's (the
kernels' classes are in ``kernels.ops``; ``fp8_encode`` is BITWISE).  The
gathers are pure data movement (BITWISE).  A multi-rank xla-mode fp32/bf16
reduce-scatter sums in the backend's order, not XLA's linear device order
(ALLCLOSE); the ring match route, the fp8 route and the q8 match route sum
in rank order, as the reference's (BITWISE); ``ring_acc`` sums in ring
order as the reference's ring_acc does (BITWISE against it on the same
inputs, ALLCLOSE against match mode).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from ..kernels import ops
from ..quant.fp8 import FP8_DTYPES, fp8_encode

# cast wire formats: the payload is the buffer itself in this dtype
CAST_FORMATS: dict[str, torch.dtype] = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
    **FP8_DTYPES,
}
# every format a WireCodec can take
WIRE_FORMATS: tuple[str, ...] = tuple(CAST_FORMATS) + ("q8_block",)
FP8_FORMATS: tuple[str, ...] = tuple(FP8_DTYPES)

# storage formats a ParamStore can take (core.store)
STORE_FORMATS: tuple[str, ...] = ("fp32", "bf16", "q8_block") + FP8_FORMATS
# the float8 dtypes, which collectives move as uint8 views
_FP8 = frozenset(FP8_DTYPES.values())
_FP8_FMT = {dt: name for name, dt in FP8_DTYPES.items()}

# the single-tensor collectives were renamed; take the current spelling
# where the installed torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def check_wire_format(fmt: str | None, who: str = "wire") -> None:
    if fmt is not None and fmt not in WIRE_FORMATS:
        raise ValueError(
            f"unknown {who} format {fmt!r}; expected one of "
            f"{list(WIRE_FORMATS)}")


def fmt_of_dtype(dtype: torch.dtype) -> str:
    for name, cdt in CAST_FORMATS.items():
        if cdt == dtype:
            return name
    raise ValueError(
        f"dtype {dtype} has no wire format; supported: {list(CAST_FORMATS)}")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One payload format on the FSDP wire (either direction)."""

    fmt: str = "fp32"
    block: int = 1024  # quant block (flat elements) for q8_block

    def __post_init__(self):
        check_wire_format(self.fmt, "WireCodec")
        if self.block < 1:
            raise ValueError(f"quant block must be >= 1, got {self.block}")

    @property
    def quantized(self) -> bool:
        return self.fmt == "q8_block"

    @property
    def fp8(self) -> bool:
        return self.fmt in FP8_FORMATS

    @property
    def dtype(self) -> torch.dtype:
        """Wire dtype of a cast codec (ValueError for q8_block, whose
        payload has two dtypes)."""
        if self.quantized:
            raise ValueError("q8_block payload has no single wire dtype")
        return CAST_FORMATS[self.fmt]

    def encode(self, x: torch.Tensor):
        """Dense buffer -> payload (a tensor for cast codecs, a
        ``{"codes", "scales"}`` dict for q8_block; the last dim must be a
        multiple of ``block``, the planner's align guarantee)."""
        if self.fp8:
            return fp8_encode(x, self.fmt)
        if not self.quantized:
            return x.to(self.dtype)
        codes, scales = ops.quantize(x, self.block)
        return {"codes": codes, "scales": scales}

    def decode(self, payload, out_dtype: torch.dtype) -> torch.Tensor:
        """Payload -> dense buffer in ``out_dtype``; q8_block decodes
        through ``ops.dequantize_into`` (no full-size fp32 intermediate)."""
        if not self.quantized:
            return payload.to(out_dtype)
        return ops.dequantize_into(payload["codes"], payload["scales"],
                                   self.block, out_dtype=out_dtype)

    def wire_bytes(self, n_elements: int) -> int:
        """Payload bytes of ``n_elements`` in this format."""
        if not self.quantized:
            return n_elements * self.dtype.itemsize
        return n_elements + (n_elements // self.block) * 4  # codes + scales


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _snap_chunk(rows: int, chunk, unit: int = 1) -> int:
    """Snap a requested ring-chunk size onto the largest divisor of
    ``rows`` that is <= ``chunk`` and a multiple of ``unit`` (the quant
    block for q8 payloads).  ``None`` or anything >= ``rows`` means one
    message of ``rows``.  PARITY: BITWISE (the reference's integer
    rule)."""
    if chunk is None or int(chunk) >= rows or rows % unit:
        return rows
    target = max(int(chunk), unit)
    best = 0
    i = 1
    while i * i <= rows:
        if rows % i == 0:
            for d in (i, rows // i):
                if d <= target and d % unit == 0 and d > best:
                    best = d
        i += 1
    return best or rows


def _leaf_chunk(ring_chunk, leaf_rows: int, rows: int):
    """``ring_chunk`` in a payload leaf's own rows: q8 scales have one row
    per block, so their messages stay congruent with the codes'."""
    if ring_chunk is None or leaf_rows == rows:
        return ring_chunk
    return max(int(ring_chunk) * leaf_rows // max(rows, 1), 1)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """Float8 tensors travel as their uint8 bytes."""
    return t.view(torch.uint8) if t.dtype in _FP8 else t


def _hop(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One ring hop: send each tensor to the left neighbour (rank - 1) and
    receive the right neighbour's (rank + 1) in its place, as one
    ``batch_isend_irecv``.  The reference's ``ppermute`` with perm
    ``[(i + 1) % n -> i]``."""
    n, r = _world(group), _rank(group)
    left = dist.get_global_rank(group, (r - 1) % n)
    right = dist.get_global_rank(group, (r + 1) % n)
    ops, outs = [], []
    for t in tensors:
        t = t.contiguous()
        recv = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, _raw(t), left, group))
        ops.append(dist.P2POp(dist.irecv, _raw(recv), right, group))
        outs.append(recv)
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


def _ring_all_gather(x: torch.Tensor, group, ring_chunk=None
                     ) -> torch.Tensor:
    """Ring all-gather of a flat shard: n-1 hops, each forwarding the
    shard received last, written into the output at absolute rank
    offsets.  ``ring_chunk`` splits each message into sub-chunks run as
    independent rings, interleaved back into the tiled layout.  PARITY:
    BITWISE (data movement)."""
    n = _world(group)
    if n == 1:
        return x
    c = x.shape[0]
    sub = _snap_chunk(c, ring_chunk)
    if sub != c:
        parts = [_ring_all_gather(x[i * sub:(i + 1) * sub], group)
                 for i in range(c // sub)]
        return torch.stack([p.view(n, sub) for p in parts], 1).reshape(-1)
    idx = _rank(group)
    out = torch.empty(n * c, dtype=x.dtype, device=x.device)
    out[idx * c:(idx + 1) * c] = x
    cur = x
    for k in range(1, n):
        cur, = _hop([cur], group)   # now rank (idx + k)'s shard
        j = (idx + k) % n
        out[j * c:(j + 1) * c] = cur
    return out


class _Started:
    """An all-gather in flight: ``wait()`` returns its output."""

    def __init__(self, out: torch.Tensor, work=None,
                 view_as: torch.dtype | None = None):
        self.out, self.work, self.view_as = out, work, view_as

    def wait(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.out if self.view_as is None else \
            self.out.view(self.view_as)


def start_all_gather(x: torch.Tensor, group, mode: str = "xla",
                     ring_chunk=None) -> _Started:
    """Issue the all-gather of a flat shard (``payload_all_gather``
    without the wait): the xla route as an asynchronous collective, the
    ring's hops to their end (each hop waits for the last)."""
    if group is None:
        return _Started(x)
    if mode == "ring":
        return _Started(_ring_all_gather(x, group, ring_chunk))
    fp8 = x.dtype if x.dtype in _FP8 else None
    x = _raw(x).contiguous()
    out = torch.empty(_world(group) * x.numel(), dtype=x.dtype,
                      device=x.device)
    work = _all_gather(out, x, group=group, async_op=True)
    return _Started(out, work, fp8)


def payload_all_gather(x: torch.Tensor, group, mode: str = "xla",
                       ring_chunk=None) -> torch.Tensor:
    """All-gather a flat shard over ``group`` into a new flat buffer of
    ``world * x.numel()`` elements, rank-major (the reference's tiled
    ``lax.all_gather``); pure data movement in ``x``'s dtype (float8
    codes travel as their uint8 bytes).  ``mode="ring"`` takes the ring
    route (``ring_chunk`` bounds its messages); a ``group`` of None
    returns ``x``."""
    return start_all_gather(x, group, mode, ring_chunk).wait()


def _route(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """Send chunk j of each rank's flat ``x`` to rank j un-reduced: returns
    (n, chunk), row i from rank i (float8 codes as uint8 bytes)."""
    if x.dtype in _FP8:
        return _route(x.view(torch.uint8), n, group).view(x.dtype)
    c = x.numel() // n
    recv = torch.empty(n, c, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(recv, x.reshape(n, c).contiguous(), group=group)
    return recv


def _ring_route(leaves: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Route each rank's chunks un-reduced to their destinations by ring
    hops: ``leaves`` are (n, c) per-destination rows; returns, per leaf,
    (n, c) rows in absolute rank order (row j from rank j).  The buffer in
    flight sheds the chunk that arrived home at every hop, so hop k
    carries n-1-k chunks."""
    n, idx = _world(group), _rank(group)
    # row j: this rank's contribution to rank idx + j
    rot = [torch.roll(t, -idx, 0) for t in leaves]
    parts = [[t[0]] for t in rot]
    bufs = [t[1:] for t in rot]
    for _ in range(n - 1):
        bufs = _hop(bufs, group)
        for p, b in zip(parts, bufs):
            p.append(b[-1])             # from rank idx + k, now home
        bufs = [b[:-1] for b in bufs]
    # parts[k] came from rank (idx + k) % n
    order = [(j - idx) % n for j in range(n)]
    return [torch.stack([p[k] for k in order]) for p in parts]


def _split_cols(buf: torch.Tensor, n: int, k: int, sub: int
                ) -> list[torch.Tensor]:
    """Column i of the (n*c,) buffer viewed as (n, k, sub): one
    independent sub-ring per column."""
    cols = buf.reshape(n, k, sub)
    return [cols[:, i].reshape(n * sub) for i in range(k)]


def _encode_as(total: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 -> ``dtype`` rounded once: ``fp8_encode`` for float8 (no
    library cast), a round-to-nearest-even cast otherwise."""
    if dtype in _FP8:
        return fp8_encode(total, _FP8_FMT[dtype])
    return total.to(dtype)


def _ring_reduce_scatter(ct: torch.Tensor, group, ring_chunk=None
                         ) -> torch.Tensor:
    """Order-exact ring reduce-scatter (``gather_mode="ring"``, match):
    chunks routed un-reduced to their destinations, summed there in fp32
    in absolute rank order and rounded once to ``ct``'s dtype.  PARITY:
    BITWISE vs the reference's ``_ring_reduce_scatter`` on the same
    inputs."""
    n = _world(group)
    if n == 1:
        return ct
    c = ct.numel() // n
    sub = _snap_chunk(c, ring_chunk)
    if sub != c:
        return torch.cat([_ring_reduce_scatter(col, group)
                          for col in _split_cols(ct, n, c // sub, sub)])
    rows, = _ring_route([ct.view(n, c)], group)
    total = rows[0].float()
    for j in range(1, n):
        total = total + rows[j].float()
    return _encode_as(total, ct.dtype)


def _ring_acc_reduce_scatter(ct: torch.Tensor, group, ring_chunk=None
                             ) -> torch.Tensor:
    """Accumulate-in-flight ring reduce-scatter (``reduce_mode=
    "ring_acc"``): the partial sum for rank d starts at d-1 and every hop
    adds the local contribution, in ``ct``'s dtype (float8 partials are
    added in fp32 and re-encoded), so the wire carries n-1 chunk-hops.
    PARITY: BITWISE vs the reference's ``_ring_acc_reduce_scatter`` for
    fp32 and bf16; ALLCLOSE against the match routes."""
    n = _world(group)
    if n == 1:
        return ct
    c = ct.numel() // n
    sub = _snap_chunk(c, ring_chunk)
    if sub != c:
        return torch.cat([_ring_acc_reduce_scatter(col, group)
                          for col in _split_cols(ct, n, c // sub, sub)])
    idx = _rank(group)
    chunks = torch.roll(ct.view(n, c), -idx, 0)
    acc = chunks[1 % n]                # the chain this rank starts
    for k in range(2, n + 1):
        acc, = _hop([acc], group)
        if ct.dtype in _FP8:
            acc = _encode_as(acc.float() + chunks[k % n].float(), ct.dtype)
        else:
            acc = acc + chunks[k % n]
    return acc


def _fp8_route_reduce_scatter(codes: torch.Tensor, fmt: str, group
                              ) -> torch.Tensor:
    """Reduce-scatter of an fp8 payload: every rank's codes for destination
    j go to rank j un-reduced; rank j adds its n contributions to +0 in
    float16, in rank order 0..n-1 (every fp8 value is exact in float16,
    each partial sum rounds to it), and encodes the sum once.  Returns the
    fp8 shard.

    PARITY: BITWISE vs the reference's ``psum_scatter`` on fp8 payloads on
    XLA:CPU, whose sum this is (read from its outputs: neither an exact
    sum nor per-hop fp8 rounding matches; tests/test_torch_fp8.py, 2 and
    4 ranks)."""
    n = _world(group)
    if n == 1:
        return codes
    dec = _route(codes, n, group).to(torch.float16)
    total = torch.zeros_like(dec[0])
    for j in range(n):
        total += dec[j]
    return fp8_encode(total.float(), fmt)


def _q8_split_cols(payload, block: int, n: int, k: int, sub: int):
    """Per-destination sub-chunk columns of an encoded payload: codes in
    elements, scales in elements / block (``sub`` is block-aligned)."""
    cc = _split_cols(payload["codes"], n, k, sub)
    sc = _split_cols(payload["scales"], n, k, sub // block)
    return [{"codes": a, "scales": b} for a, b in zip(cc, sc)]


def _q8_chunks(payload, block: int, n: int):
    codes, scales = payload["codes"], payload["scales"]
    c = codes.numel() // n
    if c % block:
        raise ValueError(
            f"reduce-scatter chunk size {c} not a multiple of quant block "
            f"{block} -- planner align missing for the reduce wire?")
    return codes.view(n, c), scales.view(n, c // block)


def _q8_route_reduce_scatter(payload, block: int, group, mode: str = "xla",
                             ring_chunk=None) -> torch.Tensor:
    """Order-exact quantized reduce-scatter (``reduce_mode="match"``):
    every rank's codes and scales for destination j go to rank j un-reduced
    (``all_to_all_single``; ring hops in ring mode); rank j dequantizes
    its n contributions and sums them in fp32 in rank order 0..n-1.
    Returns the fp32 shard.

    PARITY: BITWISE vs the reference's ``_q8_route_reduce_scatter`` --
    the payload is encoded once at the source and each element's sum runs
    in the same absolute order, whatever the route and ``ring_chunk``."""
    codes, scales = payload["codes"], payload["scales"]
    n = _world(group)
    if n == 1:
        return ops.dequantize(codes, scales, block)
    c = codes.numel() // n
    sub = _snap_chunk(c, ring_chunk, unit=block)
    if sub != c:
        return torch.cat([
            _q8_route_reduce_scatter(col, block, group, mode)
            for col in _q8_split_cols(payload, block, n, c // sub, sub)])
    cch, sch = _q8_chunks(payload, block, n)
    if mode == "ring":
        cr, sr = _ring_route([cch, sch], group)
    else:
        cr, sr = _route(cch, n, group), _route(sch, n, group)
    deq = ops.dequantize(cr, sr, block)  # row j came from rank j
    total = deq[0].clone()
    for j in range(1, n):
        total += deq[j]
    return total


def _q8_ring_acc_reduce_scatter(payload, block: int, group,
                                ring_chunk=None) -> torch.Tensor:
    """Accumulate-in-flight quantized reduce-scatter (``reduce_mode=
    "ring_acc"``): the partial sum rides the ring quantized (n-1
    chunk-hops of codes and scales); every hop dequantizes it, adds the
    local dequantized contribution and requantizes (not error-compensated).
    Returns the fp32 shard.  PARITY: BITWISE vs the reference's
    ``_q8_ring_acc_reduce_scatter`` on the same payload (the kernels'
    classes aside); ALLCLOSE against the match route."""
    codes, scales = payload["codes"], payload["scales"]
    n = _world(group)
    if n == 1:
        return ops.dequantize(codes, scales, block)
    c = codes.numel() // n
    sub = _snap_chunk(c, ring_chunk, unit=block)
    if sub != c:
        return torch.cat([
            _q8_ring_acc_reduce_scatter(col, block, group)
            for col in _q8_split_cols(payload, block, n, c // sub, sub)])
    cch, sch = _q8_chunks(payload, block, n)
    idx = _rank(group)
    cch, sch = torch.roll(cch, -idx, 0), torch.roll(sch, -idx, 0)
    acc_c, acc_s = cch[1 % n], sch[1 % n]
    val = None
    for k in range(2, n + 1):
        acc_c, acc_s = _hop([acc_c, acc_s], group)
        val = (ops.dequantize(acc_c, acc_s, block)
               + ops.dequantize(cch[k % n], sch[k % n], block))
        if k < n:
            acc_c, acc_s = ops.quantize(val, block)
    return val


def dtype_reduce_scatter(g: torch.Tensor, group, mode: str = "xla",
                         reduce_mode: str = "match", ring_chunk=None
                         ) -> torch.Tensor:
    """The cast-codec gradient reduce-scatter of ``g`` (already in the
    codec dtype): the accumulate-in-flight ring when ``reduce_mode`` says
    so, else the gather mode's match route (the backend's reduce-scatter,
    or the rank-order fp8 route, for xla; the order-exact ring for ring).
    A ``group`` of None returns ``g``."""
    if group is None:
        return g
    if reduce_mode == "ring_acc":
        return _ring_acc_reduce_scatter(g, group, ring_chunk)
    if mode == "ring":
        return _ring_reduce_scatter(g, group, ring_chunk)
    if g.dtype in _FP8:
        return _fp8_route_reduce_scatter(g, _FP8_FMT[g.dtype], group)
    out = torch.empty(g.numel() // _world(group), dtype=g.dtype,
                      device=g.device)
    _reduce_scatter(out, g, op=dist.ReduceOp.SUM, group=group)
    return out


def codec_reduce_scatter(ct: torch.Tensor, ef: torch.Tensor | None,
                         codec: WireCodec, group, param_dtype: torch.dtype,
                         mode: str = "xla", reduce_mode: str = "match",
                         ring_chunk=None) -> torch.Tensor:
    """Reduce-scatter a flat cotangent through ``codec``; returns this
    rank's shard in ``param_dtype``.

    Cast codecs: cast to the codec dtype, ``dtype_reduce_scatter``, cast to
    the param dtype (``ef`` must be None: a cast wire has no error to feed
    back).  q8_block: with a residual ``ef`` (this rank's, shaped like
    ``ct``) encode ``ct + ef`` through ``ops.encode_ef`` and write the
    fresh quantization error into ``ef`` in place; without one encode
    ``ct.f32`` through ``codec.encode``.  Then the match or ring_acc q8
    route.  With one rank (or no group) the encode/decode round trip still
    runs, so a one-card run has the wire numerics of a sharded one."""
    if not codec.quantized:
        if ef is not None:
            raise ValueError(
                f"error feedback is only defined for quantized reduce "
                f"wires, got codec {codec.fmt!r}")
        g = dtype_reduce_scatter(codec.encode(ct).contiguous(), group, mode,
                                 reduce_mode, ring_chunk)
        return g.to(param_dtype)
    if ef is not None:
        codes, scales, _ = ops.encode_ef(
            ct, ef, codec.block,
            out=(torch.empty(ct.shape, dtype=torch.int8, device=ct.device),
                 torch.empty(ct.shape[:-1] + (ct.shape[-1] // codec.block,),
                             dtype=torch.float32, device=ct.device),
                 ef))
        payload = {"codes": codes, "scales": scales}
    else:
        payload = codec.encode(ct.float())
    if reduce_mode == "ring_acc":
        shard = _q8_ring_acc_reduce_scatter(payload, codec.block, group,
                                            ring_chunk)
    else:
        shard = _q8_route_reduce_scatter(payload, codec.block, group, mode,
                                         ring_chunk)
    return shard.to(param_dtype)


@dataclasses.dataclass(frozen=True)
class ReduceRoute:
    """How a gather's backward reduce-scatters: the codec, the gather and
    reduce modes and the ring chunk."""

    codec: WireCodec
    mode: str = "xla"
    reduce_mode: str = "match"
    ring_chunk: int | None = None


def _check_sink(shard: torch.Tensor, grad_sink: torch.Tensor) -> None:
    if shard.shape != grad_sink.shape or shard.dtype != grad_sink.dtype:
        raise ValueError(
            f"grad sink {tuple(grad_sink.shape)}/{grad_sink.dtype} does not "
            f"match shard {tuple(shard.shape)}/{shard.dtype}")


def _check_ef(ef: torch.Tensor | None, group, shard: torch.Tensor) -> None:
    if ef is None:
        return
    want = (_world(group) * shard.numel(),)
    if tuple(ef.shape) != want or ef.dtype != torch.float32:
        raise ValueError(
            f"error-feedback residual {tuple(ef.shape)}/{ef.dtype} must be "
            f"float32 of shape {want} (the gathered buffer)")


class _Gather(torch.autograd.Function):
    """Forward: ``fetch()`` (a gather and its decode); backward: the
    cotangent reduce-scattered into ``grad_sink`` (the master's
    gradient), or with ``defer`` (deferred error feedback) added to that
    fp32 accumulator, with no encode and no collective: the boundary
    reduce-scatters the sum once (``core.fsdp``)."""

    @staticmethod
    def forward(ctx, master, grad_sink, ef, group, route, fetch, defer):
        ctx.grad_sink, ctx.ef, ctx.defer = grad_sink, ef, defer
        ctx.group, ctx.route = group, route
        return fetch()

    @staticmethod
    def backward(ctx, ct):
        if ctx.defer is not None:
            ctx.defer.add_(ct)
            return (None,) * 7
        sink, r = ctx.grad_sink, ctx.route
        sink.add_(codec_reduce_scatter(ct, ctx.ef, r.codec, ctx.group,
                                       sink.dtype, r.mode, r.reduce_mode,
                                       r.ring_chunk))
        return (None,) * 7


def start_codec_gather(shard: torch.Tensor, group, gather_codec: WireCodec,
                       mode: str = "xla", ring_chunk=None
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Issue a flat store's gather (encode and all-gather, asynchronously
    where the route allows); returns ``finish(out_dtype)``, which waits
    and decodes."""
    with torch.no_grad():
        started = start_all_gather(gather_codec.encode(shard.detach()),
                                   group, mode, ring_chunk)
    return lambda out_dtype: gather_codec.decode(started.wait(), out_dtype)


def codec_gather(shard: torch.Tensor, grad_sink: torch.Tensor, group,
                 gather_codec: WireCodec, route: ReduceRoute,
                 out_dtype: torch.dtype, ef: torch.Tensor | None = None,
                 started=None, defer: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """All-gather one rank's flat shard ``shard`` (``S`` elements) into the
    ``world * S`` compute-dtype buffer.  ``shard`` must require grad (it is
    a view of a parameter leaf) for the backward to be recorded; its
    reduce-scattered gradient is accumulated into ``grad_sink`` (the
    matching view of the leaf's ``.grad``), so a stacked ``(L, S)`` leaf
    collects every layer's shard in place, without an ``(L, S)`` gradient
    per layer.  ``ef`` (``world * S`` fp32, a q8 reduce codec only) is the
    error-feedback residual; the backward replaces it with the new one (the
    reference's ``codec_gather_ef``, whose updated residual comes back as
    ``ef``'s cotangent).  ``started``: the ``start_codec_gather`` of the
    same shard, issued earlier.  ``defer`` (``ef``'s shape, fp32): the
    backward adds the cotangent there instead, and neither encodes nor
    reduces (the reference's ``codec_gather_defer_ef``)."""
    _check_sink(shard, grad_sink)
    _check_ef(ef, group, shard)
    _check_ef(defer, group, shard)
    finish = started or start_codec_gather(shard, group, gather_codec,
                                           route.mode, route.ring_chunk)
    return _Gather.apply(shard, grad_sink, ef, group, route,
                         lambda: finish(out_dtype), defer)


def start_q8_gather(codes: torch.Tensor, scales: torch.Tensor, group,
                    block: int, mode: str = "xla", ring_chunk=None):
    """Issue the gather of a q8 payload; ``finish(out_dtype)`` waits and
    decodes it through ``ops.dequantize_into``."""
    c = start_all_gather(codes, group, mode, ring_chunk)
    s = start_all_gather(scales, group, mode,
                         _leaf_chunk(ring_chunk, scales.numel(),
                                     codes.numel()))
    return lambda out_dtype: ops.dequantize_into(
        c.wait(), s.wait(), block, out_dtype=out_dtype)


def q8_gather(master: torch.Tensor, codes: torch.Tensor,
              scales: torch.Tensor, grad_sink: torch.Tensor, group,
              block: int, route: ReduceRoute, out_dtype: torch.dtype,
              ef: torch.Tensor | None = None, started=None,
              defer: torch.Tensor | None = None) -> torch.Tensor:
    """The quantized store's gather: all-gather this rank's ``codes``
    (``S`` int8) and ``scales`` (``S / block`` fp32) and decode them into
    the ``world * S`` compute-dtype buffer.  The gradient goes straight
    through to the fp32 ``master`` shard: backward reduce-scatters the
    cotangent through ``route`` into ``grad_sink`` (and, with a q8 reduce
    wire, updates the residual ``ef``), as ``codec_gather`` does.
    ``master`` must require grad for the backward to be recorded;
    ``defer`` as in ``codec_gather`` (``codec_grad_proxy_defer_ef``).

    PARITY: BITWISE -- the reference's ``deq + codec_grad_proxy(...)``
    without the +0.0 add (see the module docstring)."""
    _check_sink(master, grad_sink)
    _check_ef(ef, group, master)
    _check_ef(defer, group, master)
    if codes.shape != master.shape or scales.numel() * block != codes.numel():
        raise ValueError(
            f"q8 payload codes {tuple(codes.shape)} / scales "
            f"{tuple(scales.shape)} do not match the master shard "
            f"{tuple(master.shape)} in blocks of {block}")
    finish = started or start_q8_gather(codes, scales, group, block,
                                        route.mode, route.ring_chunk)
    return _Gather.apply(master, grad_sink, ef, group, route,
                         lambda: finish(out_dtype), defer)


def start_fp8_gather(codes: torch.Tensor, group, mode: str = "xla",
                     ring_chunk=None):
    """Issue the gather of fp8 codes; ``finish(out_dtype)`` waits and
    casts them."""
    c = start_all_gather(codes, group, mode, ring_chunk)
    return lambda out_dtype: c.wait().to(out_dtype)


def fp8_gather(master: torch.Tensor, codes: torch.Tensor,
               grad_sink: torch.Tensor, group, route: ReduceRoute,
               out_dtype: torch.dtype, ef: torch.Tensor | None = None,
               started=None, defer: torch.Tensor | None = None
               ) -> torch.Tensor:
    """The fp8 store's gather: all-gather this rank's float8 ``codes``
    (``S`` elements, 1 B each) and cast them to the compute dtype; the
    gradient goes straight through to the fp32 ``master`` shard, as in
    ``q8_gather`` (``defer`` likewise).  PARITY: BITWISE but for the sign
    of a zero (the module docstring)."""
    _check_sink(master, grad_sink)
    _check_ef(ef, group, master)
    _check_ef(defer, group, master)
    if codes.shape != master.shape or codes.dtype not in _FP8:
        raise ValueError(
            f"fp8 payload {codes.dtype} {tuple(codes.shape)} does not match "
            f"the master shard {tuple(master.shape)}")
    finish = started or start_fp8_gather(codes, group, route.mode,
                                         route.ring_chunk)
    return _Gather.apply(master, grad_sink, ef, group, route,
                         lambda: finish(out_dtype), defer)
