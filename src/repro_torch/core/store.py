"""ParamStore: the storage format of a group's sharded parameter buffer
(port of ``repro/core/store.py``).

  * ``fp32`` -- one fp32 flat buffer; master weights == stored weights.
    Without a residual the state is the bare rank-local tensor, as in the
    reference.
  * ``bf16`` -- one bf16 flat buffer, the leaf itself (half the parameter
    memory; its gradient is bf16 too).  The optimizer computes in fp32 and
    rounds w' back to bf16 in its fused pass.
  * ``fp8_e4m3`` / ``fp8_e5m2`` -- float8 codes beside the fp32 master,
    state ``{"codes", "master"}``: the all-gather moves the codes (1 B an
    element, no scales) and decodes them with one cast; the gradient
    reduce-scatters to the master, which the optimizer updates and
    re-encodes (``quant.fp8`` semantics) in one fused pass.  Scale-free, so
    no planner alignment.
  * ``q8_block`` -- block-wise INT8 codes + one fp32 absmax scale per
    ``block`` elements, beside the fp32 master.  The all-gather moves the
    codes and scales and decodes them locally; the gradient reduce-scatters
    to the master, which the optimizer updates and requantizes in one fused
    pass.
  * ``ef_m`` > 0 adds the q8 reduce wire's error-feedback residual
    (``reduce_ef``, fp32): ``ef_m`` is the group's FSDP world size m, and
    each rank's residual is m shards long (its local gradient
    contribution).

A dict state holds ``state_keys()`` as tensors on the runtime's device.
The master is the leaf that requires grad; codes, scales and the residual
do not.  Where the reference threads the residual through ``jax.grad``
(its updated value comes back as the residual's cotangent), the port's
gather backward writes it into the ``reduce_ef`` tensor in place, so
``trainable`` is the master alone.

PARITY: BITWISE -- ``create`` is the identity on the fp32 buffer, a
round-to-nearest-even cast for bf16, ``quant.fp8.fp8_encode`` for fp8 and
``ops.quantize`` on the master (per-shard quantization equals the
reference's global-buffer one because the planner aligns the shard size to
the block); ``gather`` dispatches over the wire primitives, whose classes
are in ``core.wire``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from ..kernels import ops
from ..quant.fp8 import FP8_DTYPES, fp8_encode
from .schedule import CommSchedule
from .wire import (STORE_FORMATS, WireCodec, codec_gather, fp8_gather,
                   payload_all_gather, q8_gather)

# q8_block state keys, in the reference's (tree-sorted) order; a state with
# a residual appends EF_KEY (see ``state_keys``)
Q8_KEYS = ("codes", "master", "scales")
# fp8 state keys: float8 codes + fp32 master, no scales
FP8_KEYS = ("codes", "master")
# the reduce-wire error-feedback residual leaf (fp32, contribution-sized)
EF_KEY = "reduce_ef"


@dataclasses.dataclass(frozen=True)
class ParamStore:
    """Storage-format policy for one communication group's buffer."""

    fmt: str = "fp32"
    block: int = 1024  # quant block (flat elements) for q8_block
    ef_m: int = 0      # reduce-wire EF residual chunks (0 = no residual)

    def __post_init__(self):
        if self.fmt not in STORE_FORMATS:
            raise ValueError(
                f"unknown param_store {self.fmt!r}; expected one of "
                f"{list(STORE_FORMATS)}")
        if self.block < 1:
            raise ValueError(f"quant block must be >= 1, got {self.block}")
        if self.ef_m < 0:
            raise ValueError(f"ef_m must be >= 0, got {self.ef_m}")

    # ------------------------------------------------------------------ #
    # format properties
    # ------------------------------------------------------------------ #
    @property
    def quantized(self) -> bool:
        return self.fmt == "q8_block"

    @property
    def fp8(self) -> bool:
        """True for the float8 code + master formats."""
        return self.fmt in FP8_DTYPES

    @property
    def fp8_dtype(self) -> torch.dtype:
        """The float8 code dtype of an fp8 store."""
        if not self.fp8:
            raise ValueError(f"fp8_dtype on a {self.fmt!r} store")
        return FP8_DTYPES[self.fmt]

    @property
    def has_ef(self) -> bool:
        return self.ef_m > 0

    @property
    def storage_dtype(self) -> torch.dtype:
        """Dtype of the trainable buffer (the leaf the gradient targets)."""
        return torch.bfloat16 if self.fmt == "bf16" else torch.float32

    def align(self) -> int:
        """Planner alignment this store needs: a quantized store, and a
        quantized reduce wire (its chunks are shard-sized), pin tensor
        starts and the shard size to the quant block."""
        return self.block if (self.quantized or self.has_ef) else 1

    def state_keys(self) -> tuple[str, ...] | None:
        """Leaf names of a dict state (None: the state is a bare tensor)."""
        if self.quantized:
            keys = Q8_KEYS
        elif self.fp8:
            keys = FP8_KEYS
        else:
            keys = ("master",) if self.has_ef else None
        if keys is None:
            return None
        return keys + ((EF_KEY,) if self.has_ef else ())

    def leaf_dtype(self, key: str) -> torch.dtype:
        if key == "codes":
            return self.fp8_dtype if self.fp8 else torch.int8
        if key == "master":
            return torch.float32 if (self.quantized or self.fp8) \
                else self.storage_dtype
        return {"scales": torch.float32, EF_KEY: torch.float32}[key]

    def leaf_shape(self, key: str, shape: tuple[int, ...]
                   ) -> tuple[int, ...]:
        """Shape of leaf ``key`` for a buffer of ``shape`` (global or
        rank-local alike): scales have one entry per block, the residual is
        ``ef_m`` buffers long."""
        if key == "scales":
            if shape[-1] % self.block:
                raise ValueError(
                    f"buffer last dim {shape[-1]} not a multiple of quant "
                    f"block {self.block} -- planner align missing?")
            return shape[:-1] + (shape[-1] // self.block,)
        if key == EF_KEY:
            return shape[:-1] + (shape[-1] * self.ef_m,)
        return tuple(shape)

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #
    def create(self, master: torch.Tensor):
        """State from this rank's fp32 master shard (a leaf that requires
        grad), on its device: the shard itself for fp32, its bf16 rounding
        (a new leaf) for bf16, else a dict whose codes come from
        ``fp8_encode`` or, with scales, from ``ops.quantize`` (the kernel,
        on a card) and whose residual starts at zero."""
        if self.fmt == "bf16":
            master = master.detach().to(torch.bfloat16).requires_grad_(
                master.requires_grad)
        if not self.state_keys():
            return master
        state = {"master": master}
        if self.fp8:
            state["codes"] = fp8_encode(master.detach(), self.fmt)
        if self.quantized:
            with torch.no_grad():
                state["codes"], state["scales"] = ops.quantize(
                    master.detach(), self.block)
        if self.has_ef:
            state[EF_KEY] = torch.zeros(
                self.leaf_shape(EF_KEY, tuple(master.shape)),
                dtype=torch.float32, device=master.device)
        return {k: state[k] for k in self.state_keys()}

    # ------------------------------------------------------------------ #
    # views of a state
    # ------------------------------------------------------------------ #
    def trainable(self, state) -> torch.Tensor:
        """The master buffer the gradient reduce-scatter targets (the leaf
        whose ``.grad`` the train step reads)."""
        return state["master"] if isinstance(state, dict) else state

    def frozen(self, state):
        """The rest of the state: the q8 or fp8 codes, the q8 scales and
        the residual (None for a bare state)."""
        if not isinstance(state, dict):
            return None
        return {k: v for k, v in state.items() if k != "master"}

    def combine(self, trainable: torch.Tensor, frozen):
        """Inverse of (trainable, frozen): the full state again."""
        if frozen is None:
            return trainable
        return {k: trainable if k == "master" else frozen[k]
                for k in self.state_keys()}

    def master_f32(self, state) -> torch.Tensor:
        """fp32 view of (a chunk of) the weights an optimizer updates: the
        master itself for the fp32, fp8 and q8_block stores (so an update
        writes it in place), an fp32 copy of a bf16 buffer.  ``state`` is a
        store state or a view of its trainable buffer."""
        buf = self.trainable(state)
        return buf if buf.dtype == torch.float32 else buf.float()

    @torch.no_grad()
    def rebuild(self, state):
        """Bring ``state``'s coded leaves in line with its updated master,
        in place, and return the core state (``wrap_core``; the residual is
        not touched).  The optimizer has already written the new fp32
        values into the trainable buffer through ``master_f32`` (a bf16
        buffer takes them by the round-to-nearest-even cast, chunk by
        chunk: ``optim.common.write_decayed``).  An fp8 store re-encodes
        its codes with ``fp8_encode`` (no library cast: JAX's e4m3 gives
        NaN past 464 where torch saturates at 448); a q8_block store
        requantizes codes and scales with ``ops.quantize`` (the kernel on a
        card, one launch per group).  The leaves stay the same tensors, so
        the gather reads them and ``.grad`` stays on the master.  PARITY:
        BITWISE vs the reference's ``rebuild`` on the same master."""
        buf = self.trainable(state)
        if not (self.quantized or self.fp8):
            return self.wrap_core(buf)
        if self.fp8:
            state["codes"].copy_(fp8_encode(buf, self.fmt))
        else:
            codes, scales = ops.quantize(buf, self.block)
            state["codes"].copy_(codes)
            state["scales"].copy_(scales)
        return {k: state[k] for k in self.state_keys() if k != EF_KEY}

    def wrap_core(self, core):
        """A rebuilt core (the fused update's output: a bare tensor, or the
        q8 ``{"codes", "master", "scales"}`` or fp8 ``{"codes", "master"}``
        dict) as this store's state,
        minus the residual (``attach_ef`` re-attaches it)."""
        if self.has_ef and not isinstance(core, dict):
            return {"master": core}
        return core

    def attach_ef(self, core_state, ef: torch.Tensor):
        """Re-attach the residual to a rebuilt state."""
        if not self.has_ef:
            raise ValueError("attach_ef on a store without an EF residual")
        if not isinstance(core_state, dict):
            core_state = {"master": core_state}
        return {**core_state, EF_KEY: ef}

    # ------------------------------------------------------------------ #
    # the gather
    # ------------------------------------------------------------------ #
    def gather(self, state, grad_sink: torch.Tensor | None, group,
               sched: CommSchedule, compute_dtype: torch.dtype
               ) -> torch.Tensor:
        """All-gather one rank-local (one-layer) state into the flat
        compute-dtype buffer the model unpacks; backward reduce-scatters
        into ``grad_sink`` through the schedule's reduce codec, and with a
        residual writes the new one into ``state["reduce_ef"]``.  With
        ``grad_sink`` None (the serve steps) only the forward runs: the same
        gather and decode, no autograd node and no gradient route."""
        if grad_sink is None:
            if self.quantized:
                p = self.gather_payload(state, group)
                return ops.dequantize_into(p["codes"], p["scales"],
                                           self.block, out_dtype=compute_dtype)
            if self.fp8:
                return payload_all_gather(state["codes"], group).to(
                    compute_dtype)
            codec = sched.gather_codec(compute_dtype)
            return codec.decode(payload_all_gather(
                codec.encode(self.trainable(state)), group), compute_dtype)
        rcodec = sched.reduce_codec(compute_dtype, self.block)
        ef = state[EF_KEY] if self.has_ef else None
        if self.quantized:
            return q8_gather(state["master"], state["codes"], state["scales"],
                             grad_sink, group, self.block, rcodec,
                             compute_dtype, ef)
        if self.fp8:
            return fp8_gather(state["master"], state["codes"], grad_sink,
                              group, rcodec, compute_dtype, ef)
        return codec_gather(self.trainable(state), grad_sink, group,
                            sched.gather_codec(compute_dtype), rcodec,
                            compute_dtype, ef)

    def gather_payload(self, state, group) -> dict[str, torch.Tensor]:
        """All-gather a quantized state's payload without decoding:
        ``{"codes", "scales"}`` of the full flat buffer, pure data movement
        (the serve quant mode keeps these in int8 and unpacks them with
        ``DBuffer.unpack_quant``).  PARITY: BITWISE."""
        if not self.quantized:
            raise ValueError(
                f"gather_payload on a {self.fmt!r} store (quantized only)")
        return {"codes": payload_all_gather(state["codes"], group),
                "scales": payload_all_gather(state["scales"], group)}

    # ------------------------------------------------------------------ #
    # accounting
    # ------------------------------------------------------------------ #
    def wire_bytes(self, n_elements: int, wire_dtype: torch.dtype) -> int:
        """Bytes one all-gather of an ``n_elements`` buffer puts on the
        wire in this format (per gathered copy): an fp8 store ships its
        1-byte codes."""
        if self.fp8:
            return n_elements * self.fp8_dtype.itemsize
        if not self.quantized:
            return n_elements * wire_dtype.itemsize
        return WireCodec("q8_block", self.block).wire_bytes(n_elements)


def check_state(store: ParamStore, state: Mapping[str, Any] | Any,
                shape: tuple[int, ...], what: str) -> None:
    """Raise unless ``state`` has ``store``'s leaves at buffer ``shape``."""
    keys = store.state_keys()
    if keys is None:
        leaves = {"master": state}
    elif isinstance(state, Mapping) and set(state) == set(keys):
        leaves = state
    else:
        got = sorted(state) if isinstance(state, Mapping) else "a bare array"
        raise ValueError(
            f"{what} has leaves {got}, the {store.fmt!r} store needs "
            f"{list(keys or ('master',))}")
    for k, leaf in leaves.items():
        want = store.leaf_shape(k, tuple(shape))
        if tuple(leaf.shape) != want:
            name = what if keys is None else f"{what}[{k!r}]"
            raise ValueError(
                f"{name} has shape {tuple(leaf.shape)}, the port's layout "
                f"needs {want}")
