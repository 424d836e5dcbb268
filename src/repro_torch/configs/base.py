"""Config system: model architecture + parallelism (port of
``repro/configs/base.py``).

The dataclasses keep the reference's field names and defaults so a config
built on either side describes the same model; ``ModelConfig.reduced()``
derives the same CPU smoke variant (2 layers, d_model<=256, vocab<=512).
Fields the port cannot run yet (MoE, SSM, VLM, audio) stay so that the
shapes line up field for field; ``models.transformer.DecoderLM`` raises
``NotImplementedError`` on them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How one architecture maps onto the mesh: the port's ``(data,
    model)`` mesh over one ``torch.distributed`` process group
    (``launch.mesh``; a bare group is ``(world_size, 1)``).  ``tp`` and
    ``ep`` run over the model axis and must equal its size when above 1.
    The schedule knobs lower onto ``core.schedule.CommSchedule``; the ones
    the port does not run yet raise ``NotImplementedError`` there or in
    ``core.fsdp.FSDPRuntime``."""

    fsdp_axes: tuple[str, ...] = ("data", "model")
    batch_axes: tuple[str, ...] = ("data", "model")
    tp: int = 1
    ep: int = 1
    pod_fsdp: bool = False
    sequence_parallel: bool = False
    microbatches: int = 1

    # --- communication schedule (core.schedule.CommSchedule) ----------------
    prefetch: bool = False
    reshard_after_forward: bool = True
    keep_last_gathered: bool = False
    gather_dtype: Optional[str] = None
    reduce_dtype: Optional[str] = None
    reduce_wire: Optional[str] = None
    gather_mode: str = "xla"
    reduce_mode: str = "match"
    param_store: str = "fp32"
    group_schedules: Optional[Mapping[str, Mapping[str, Any]]] = None

    def __post_init__(self):
        if self.tp > 1 and "model" in self.fsdp_axes:
            raise ValueError(
                f"tp={self.tp} shards activations over 'model'; fsdp_axes "
                f"{self.fsdp_axes} must not ZeRO-shard parameters over it "
                f"too")
        if self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1, got {self.microbatches}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention variants -------------------------------------------------
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_alternate: bool = False
    post_norms: bool = False

    # --- mlp ----------------------------------------------------------------
    mlp: str = "swiglu"  # swiglu | geglu | squared_relu

    # --- moe ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- vlm / audio / ssm (not ported; kept for field parity) --------------
    cross_attn_interval: int = 0
    n_patches: int = 1024
    encoder_layers: int = 0
    n_frames: int = 1024
    ssm_state: int = 0
    conv_kernel: int = 4
    slstm_every: int = 0
    ssm_expand: int = 2

    # --- misc ----------------------------------------------------------------
    attn_chunk: int = 1024  # KV-chunk for online-softmax attention
    ce_chunk: int = 0       # vocab-chunked CE (0 = materialize logits)
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    source: str = ""

    # --- parallel + training defaults ---------------------------------------
    parallel: ParallelConfig = ParallelConfig()
    optimizer: str = "adamw"
    quant_block: int = 1024
    learning_rate: float = 3e-4

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family, 2 layers, d_model<=256 (the
        reference's ``reduced()``, field for field)."""
        d = min(self.d_model, 256)
        heads = max(2, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = d // heads
        return dataclasses.replace(
            self,
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            sliding_window=min(self.sliding_window, 16)
            if self.sliding_window
            else None,
            cross_attn_interval=2 if self.cross_attn_interval else 0,
            n_patches=8,
            encoder_layers=2 if self.encoder_layers else 0,
            n_frames=16,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            slstm_every=2 if self.slstm_every else 0,
            parallel=ParallelConfig(
                fsdp_axes=("data",), batch_axes=("data",), microbatches=1
            ),
            quant_block=64,
        )
