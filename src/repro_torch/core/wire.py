"""WireCodec and the ZeRO-3 gather/reduce-scatter pair (port of
``repro/core/wire.py``: the cast codecs, the ``q8_block`` codec, the
match-mode reduce-scatter and the error-feedback gathers).

  * ``WireCodec`` -- one payload format on the wire.  Cast codecs
    (``fp32``, ``bf16``): the payload is the buffer itself in that dtype;
    ``encode``/``decode`` are casts.  ``q8_block``: the payload is
    ``{"codes": int8, "scales": fp32 per block}``, encoded by
    ``kernels.ops.quantize`` and decoded by ``ops.dequantize_into``.
  * ``codec_reduce_scatter`` -- the gradient reduce-combine rule.  Cast
    codecs reduce-scatter with SUM in the codec dtype.  The q8 codec
    encodes the cotangent once (with error feedback through
    ``ops.encode_ef``), routes each destination's codes and scales to it
    un-reduced (``all_to_all_single``), and the destination dequantizes
    its n contributions and sums them in fp32 in rank order 0..n-1 -- the
    reference's match mode, bitwise comparable with it.
  * ``codec_gather`` -- one ``torch.autograd.Function`` for flat stores:
    forward casts the rank's shard to the wire dtype, all-gathers it and
    casts to the compute dtype; backward is ``codec_reduce_scatter`` into
    the gradient buffer it was handed, and with a residual ``ef`` it also
    writes the new residual into ``ef``.
  * ``q8_gather`` -- the same for a quantized store: forward all-gathers the
    stored codes and scales (``payload_all_gather``) and decodes them into
    the compute dtype; backward routes the gradient straight through to the
    fp32 master shard.  The reference adds ``codec_grad_proxy``'s zeros to
    the decoded buffer; that adds +0.0 to values that are never -0.0
    (int8 codes times a scale >= 0), so the port skips the add.

Not ported yet: the ``ring_acc`` q8 route (ROADMAP Queue 1 item 10), the
deferred error feedback of gradient accumulation (item 18) and the fp8
wire formats (item 9).

PARITY: the casts, encodes and decodes are op-for-op the reference's (the
kernels' classes are in ``kernels.ops``).  A multi-rank cast
reduce-scatter sums in the backend's order, not XLA's linear device order
(allclose); the q8 route sums in rank order, like the reference (bitwise).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..kernels import ops

# cast wire formats: the payload is the buffer itself in this dtype
CAST_FORMATS: dict[str, torch.dtype] = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
}
# every format a WireCodec can take in the port
WIRE_FORMATS: tuple[str, ...] = tuple(CAST_FORMATS) + ("q8_block",)
# fp8 wire formats of the reference, still to port
FP8_FORMATS: tuple[str, ...] = ("fp8_e4m3", "fp8_e5m2")

# storage formats the reference's ParamStore knows; the port runs fp32 and
# q8_block (core.store raises NotImplementedError on the others)
STORE_FORMATS: tuple[str, ...] = ("fp32", "bf16", "q8_block") + FP8_FORMATS

# the single-tensor collectives were renamed; take the current spelling
# where the installed torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def check_wire_format(fmt: str | None, who: str = "wire") -> None:
    if fmt is None or fmt in WIRE_FORMATS:
        return
    if fmt in FP8_FORMATS:
        raise NotImplementedError(
            f"the {fmt} {who} format is not ported yet (ROADMAP Queue 1 "
            f"item 9)")
    raise ValueError(
        f"unknown {who} format {fmt!r}; expected one of "
        f"{list(CAST_FORMATS) + list(FP8_FORMATS) + ['q8_block']}")


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


def payload_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather a flat shard over ``group`` into a new flat buffer of
    ``world * x.numel()`` elements, rank-major (the reference's tiled
    ``lax.all_gather``); pure data movement in ``x``'s dtype."""
    world = dist.get_world_size(group)
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    return out


def _q8_route_reduce_scatter(payload, block: int, group) -> torch.Tensor:
    """Order-exact quantized reduce-scatter (reduce_mode="match"): every
    rank's codes and scales for destination j go to rank j un-reduced
    (``all_to_all_single``); rank j dequantizes its n contributions and
    sums them in fp32 in rank order 0..n-1.  Returns the fp32 shard.

    PARITY: BITWISE vs the reference's ``_q8_route_reduce_scatter`` --
    the payload is encoded once at the source and each element's sum runs
    in the same absolute order."""
    codes, scales = payload["codes"], payload["scales"]
    n = dist.get_world_size(group)
    if n == 1:
        return ops.dequantize(codes, scales, block)
    c = codes.numel() // n
    if c % block:
        raise ValueError(
            f"reduce-scatter chunk size {c} not a multiple of quant block "
            f"{block} -- planner align missing for the reduce wire?")
    recv_c = torch.empty(n, c, dtype=codes.dtype, device=codes.device)
    recv_s = torch.empty(n, c // block, dtype=scales.dtype,
                         device=scales.device)
    dist.all_to_all_single(recv_c, codes.reshape(n, c).contiguous(),
                           group=group)
    dist.all_to_all_single(recv_s, scales.reshape(n, c // block).contiguous(),
                           group=group)
    deq = ops.dequantize(recv_c, recv_s, block)  # row j came from rank j
    total = deq[0].clone()
    for j in range(1, n):
        total += deq[j]
    return total


def codec_reduce_scatter(ct: torch.Tensor, ef: torch.Tensor | None,
                         codec: WireCodec, group, param_dtype: torch.dtype
                         ) -> torch.Tensor:
    """Reduce-scatter a flat cotangent through ``codec``; returns this
    rank's shard in ``param_dtype``.

    Cast codecs: cast to the codec dtype, reduce-scatter (SUM), cast to the
    param dtype (``ef`` must be None: a lossless wire has no error to feed
    back).  q8_block: with a residual ``ef`` (this rank's, shaped like
    ``ct``) encode ``ct + ef`` through ``ops.encode_ef`` and write the
    fresh quantization error into ``ef`` in place; without one encode
    ``ct.f32`` through ``codec.encode``.  Then the match-mode route.  With
    one rank the encode/decode round trip still runs, so a one-card run has
    the wire numerics of a sharded one."""
    if not codec.quantized:
        if ef is not None:
            raise ValueError(
                f"error feedback is only defined for quantized reduce "
                f"wires, got codec {codec.fmt!r}")
        world = dist.get_world_size(group)
        wire = codec.encode(ct).contiguous()
        out = torch.empty(wire.numel() // world, dtype=wire.dtype,
                          device=wire.device)
        _reduce_scatter(out, wire, op=dist.ReduceOp.SUM, group=group)
        return out.to(param_dtype)
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
    shard = _q8_route_reduce_scatter(payload, codec.block, group)
    return shard.to(param_dtype)


def _check_sink(shard: torch.Tensor, grad_sink: torch.Tensor) -> None:
    if shard.shape != grad_sink.shape or shard.dtype != grad_sink.dtype:
        raise ValueError(
            f"grad sink {tuple(grad_sink.shape)}/{grad_sink.dtype} does not "
            f"match shard {tuple(shard.shape)}/{shard.dtype}")


def _check_ef(ef: torch.Tensor | None, group, shard: torch.Tensor) -> None:
    if ef is None:
        return
    want = (dist.get_world_size(group) * shard.numel(),)
    if tuple(ef.shape) != want or ef.dtype != torch.float32:
        raise ValueError(
            f"error-feedback residual {tuple(ef.shape)}/{ef.dtype} must be "
            f"float32 of shape {want} (the gathered buffer)")


class _CodecGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, grad_sink, ef, group, gather_codec, reduce_codec,
                out_dtype):
        ctx.grad_sink, ctx.ef = grad_sink, ef
        ctx.group, ctx.reduce_codec = group, reduce_codec
        gathered = payload_all_gather(gather_codec.encode(shard), group)
        return gather_codec.decode(gathered, out_dtype)

    @staticmethod
    def backward(ctx, ct):
        sink = ctx.grad_sink
        sink.add_(codec_reduce_scatter(ct, ctx.ef, ctx.reduce_codec,
                                       ctx.group, sink.dtype))
        return None, None, None, None, None, None, None


def codec_gather(shard: torch.Tensor, grad_sink: torch.Tensor, group,
                 gather_codec: WireCodec, reduce_codec: WireCodec,
                 out_dtype: torch.dtype, ef: torch.Tensor | None = None
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
    ``ef``'s cotangent)."""
    _check_sink(shard, grad_sink)
    _check_ef(ef, group, shard)
    return _CodecGather.apply(shard, grad_sink, ef, group, gather_codec,
                              reduce_codec, out_dtype)


class _Q8Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, master, codes, scales, grad_sink, ef, group, block,
                reduce_codec, out_dtype):
        ctx.grad_sink, ctx.ef = grad_sink, ef
        ctx.group, ctx.reduce_codec = group, reduce_codec
        return ops.dequantize_into(payload_all_gather(codes, group),
                                   payload_all_gather(scales, group), block,
                                   out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, ct):
        sink = ctx.grad_sink
        sink.add_(codec_reduce_scatter(ct, ctx.ef, ctx.reduce_codec,
                                       ctx.group, sink.dtype))
        return (None,) * 9


def q8_gather(master: torch.Tensor, codes: torch.Tensor,
              scales: torch.Tensor, grad_sink: torch.Tensor, group,
              block: int, reduce_codec: WireCodec, out_dtype: torch.dtype,
              ef: torch.Tensor | None = None) -> torch.Tensor:
    """The quantized store's gather: all-gather this rank's ``codes``
    (``S`` int8) and ``scales`` (``S / block`` fp32) and decode them into
    the ``world * S`` compute-dtype buffer.  The gradient goes straight
    through to the fp32 ``master`` shard: backward reduce-scatters the
    cotangent through ``reduce_codec`` into ``grad_sink`` (and, with a q8
    reduce wire, updates the residual ``ef``), as ``codec_gather`` does.
    ``master`` must require grad for the backward to be recorded.

    PARITY: BITWISE -- the reference's ``deq + codec_grad_proxy(...)``
    without the +0.0 add (see the module docstring)."""
    _check_sink(master, grad_sink)
    _check_ef(ef, group, master)
    if codes.shape != master.shape or scales.numel() * block != codes.numel():
        raise ValueError(
            f"q8 payload codes {tuple(codes.shape)} / scales "
            f"{tuple(scales.shape)} do not match the master shard "
            f"{tuple(master.shape)} in blocks of {block}")
    return _Q8Gather.apply(master, codes, scales, grad_sink, ef, group, block,
                           reduce_codec, out_dtype)
