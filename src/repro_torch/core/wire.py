"""WireCodec and the ZeRO-3 gather/reduce-scatter pair (port of the cast
branch of ``repro/core/wire.py``).

  * ``WireCodec`` -- a cast codec: the payload is the buffer itself in the
    codec's dtype; ``encode``/``decode`` are dtype casts.  The quantized
    ``q8_block`` codec comes with ROADMAP Queue 1 item 7.
  * ``codec_gather`` -- one ``torch.autograd.Function``.  Forward casts the
    rank's fp32 shard to the wire dtype, all-gathers it
    (``all_gather_into_tensor``) and casts the gathered buffer to the
    compute dtype.  Backward is the ZeRO-3 gradient reduce-scatter
    (``codec_reduce_scatter``): cast the cotangent to the accum dtype,
    reduce-scatter with SUM, cast to the param dtype, and accumulate the
    shard into the gradient buffer it was handed.

PARITY: the casts are op-for-op the reference's; the sums of a multi-rank
reduce-scatter run in the backend's order, not XLA's linear device order,
so multi-rank results are allclose, one-rank results bitwise.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

# cast wire formats: the payload is the buffer itself in this dtype
CAST_FORMATS: dict[str, torch.dtype] = {
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
}

# storage formats the reference's ParamStore knows; the port runs fp32
# (core.store raises NotImplementedError on the others)
STORE_FORMATS: tuple[str, ...] = ("fp32", "bf16", "q8_block", "fp8_e4m3",
                                  "fp8_e5m2")

# the single-tensor collectives were renamed; take the current spelling
# where the installed torch has it
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def fmt_of_dtype(dtype: torch.dtype) -> str:
    for name, cdt in CAST_FORMATS.items():
        if cdt == dtype:
            return name
    raise ValueError(
        f"dtype {dtype} has no wire format; supported: {list(CAST_FORMATS)}")


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One cast payload format on the FSDP wire (either direction)."""

    fmt: str = "fp32"

    def __post_init__(self):
        if self.fmt == "q8_block":
            raise NotImplementedError(
                "the q8_block wire codec is not ported yet (ROADMAP Queue 1 "
                "item 7)")
        if self.fmt not in CAST_FORMATS:
            raise ValueError(
                f"unknown WireCodec format {self.fmt!r}; expected one of "
                f"{list(CAST_FORMATS)}")

    @property
    def dtype(self) -> torch.dtype:
        return CAST_FORMATS[self.fmt]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def decode(self, payload: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
        return payload.to(out_dtype)


def payload_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather a flat shard over ``group`` into a new flat buffer of
    ``world * x.numel()`` elements, rank-major (the reference's tiled
    ``lax.all_gather``)."""
    world = dist.get_world_size(group)
    out = torch.empty(world * x.numel(), dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    return out


def codec_reduce_scatter(ct: torch.Tensor, codec: WireCodec, group,
                         param_dtype: torch.dtype) -> torch.Tensor:
    """Cast-codec gradient reduce-scatter: cast to the codec dtype,
    reduce-scatter (SUM), cast to the param dtype -- the cast branch of the
    reference's ``codec_reduce_scatter``."""
    world = dist.get_world_size(group)
    wire = codec.encode(ct).contiguous()
    out = torch.empty(wire.numel() // world, dtype=wire.dtype,
                      device=wire.device)
    _reduce_scatter(out, wire, op=dist.ReduceOp.SUM, group=group)
    return out.to(param_dtype)


class _CodecGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, grad_sink, group, gather_codec, reduce_codec,
                out_dtype):
        ctx.grad_sink = grad_sink
        ctx.group = group
        ctx.reduce_codec = reduce_codec
        gathered = payload_all_gather(gather_codec.encode(shard), group)
        return gather_codec.decode(gathered, out_dtype)

    @staticmethod
    def backward(ctx, ct):
        sink = ctx.grad_sink
        sink.add_(codec_reduce_scatter(ct, ctx.reduce_codec, ctx.group,
                                       sink.dtype))
        return None, None, None, None, None, None


def codec_gather(shard: torch.Tensor, grad_sink: torch.Tensor, group,
                 gather_codec: WireCodec, reduce_codec: WireCodec,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """All-gather one rank's flat shard ``shard`` (``S`` elements) into the
    ``world * S`` compute-dtype buffer.  ``shard`` must require grad (it is
    a view of a parameter leaf) for the backward to be recorded; its
    reduce-scattered gradient is accumulated into ``grad_sink`` (the
    matching view of the leaf's ``.grad``), so a stacked ``(L, S)`` leaf
    collects every layer's shard in place, without an ``(L, S)`` gradient
    per layer."""
    if shard.shape != grad_sink.shape or shard.dtype != grad_sink.dtype:
        raise ValueError(
            f"grad sink {tuple(grad_sink.shape)}/{grad_sink.dtype} does not "
            f"match shard {tuple(shard.shape)}/{shard.dtype}")
    return _CodecGather.apply(shard, grad_sink, group, gather_codec,
                              reduce_codec, out_dtype)
