"""ParamStore: the storage format of a group's sharded parameter buffer
(port of the fp32 branch of ``repro/core/store.py``).

``fp32`` -- one fp32 flat buffer; master weights == stored weights.  The
state of a group is the bare rank-local tensor, ``trainable`` is that
tensor and ``frozen`` is None, as in the reference.  The bf16 and fp8
stores come with ROADMAP Queue 1 item 9, ``q8_block`` and the quantized
reduce wire's error-feedback residual with item 7.

PARITY: BITWISE -- ``create`` is the identity on the fp32 host buffer and
``gather`` is the cast-codec ``codec_gather``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedule import CommSchedule
from .wire import STORE_FORMATS, codec_gather


@dataclasses.dataclass(frozen=True)
class ParamStore:
    """Storage-format policy for one communication group's buffer."""

    fmt: str = "fp32"
    block: int = 1024
    ef_m: int = 0

    def __post_init__(self):
        if self.fmt not in STORE_FORMATS:
            raise ValueError(
                f"unknown param_store {self.fmt!r}; expected one of "
                f"{list(STORE_FORMATS)}")
        if self.fmt != "fp32":
            item = "Queue 1 item 7" if self.fmt == "q8_block" \
                else "Queue 1 item 9"
            raise NotImplementedError(
                f"param_store={self.fmt!r} is not ported yet (ROADMAP "
                f"{item})")
        if self.ef_m:
            raise NotImplementedError(
                "the reduce-wire error-feedback residual is not ported yet "
                "(ROADMAP Queue 1 item 7)")

    def create(self, master_f32: np.ndarray) -> np.ndarray:
        """State from a host-side fp32 buffer (identity for fp32)."""
        return np.asarray(master_f32, np.float32)

    def trainable(self, state: torch.Tensor) -> torch.Tensor:
        """The buffer the gradient reduce-scatter targets."""
        return state

    def frozen(self, state: torch.Tensor) -> None:
        """The non-differentiable rest of the state: none for fp32."""
        return None

    def combine(self, trainable: torch.Tensor, frozen) -> torch.Tensor:
        return trainable

    def wrap_core(self, core: torch.Tensor) -> torch.Tensor:
        """A rebuilt core (the fused update's weight output) as a state."""
        return core

    def gather(self, state: torch.Tensor, grad_sink: torch.Tensor, group,
               sched: CommSchedule, compute_dtype: torch.dtype
               ) -> torch.Tensor:
        """All-gather one rank-local state into the flat compute-dtype
        buffer the model unpacks; backward reduce-scatters into
        ``grad_sink``."""
        return codec_gather(state, grad_sink, group,
                            sched.gather_codec(compute_dtype),
                            sched.reduce_codec(compute_dtype), compute_dtype)
