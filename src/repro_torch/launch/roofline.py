"""Roofline analysis of the dry run's record (port of
``repro/launch/roofline.py``; no card).

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs_per_rank / peak FLOP/s
    memory     = bytes_per_rank / HBM bandwidth
    collective = collective_bytes_per_rank / link bandwidth

on the H100 constants of ``launch.mesh`` (``PEAK_FLOPS_BF16``, ``HBM_BW``,
``ICI_BW``: the datasheet's NVIDIA H100 80GB HBM3 at 700 W).  The reference
reads FLOPs and bytes from XLA's ``cost_analysis()`` and the collectives
from HLO text; the port reads all three from ``launch.dryrun``'s record of
one step of rank 0 on meta tensors (``StepRecord``): FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and attention, plus
``q8_matmul``'s int8 operations), bytes as each op's inputs and outputs
(a kernel at its bound bytes), and each c10d collective the wire issues
with its group size and largest buffer -- to which the reference's
ring-volume rule applies: buffer x (m-1)/m, twice that for an all-reduce.

``model_flops`` = 6 N D for a train step (2 N D forward only) with N the
active parameters, from the config alone -- the reference's numbers float
for float.  Its ``2 V D`` counts the embedding and the head even where the
head is tied to the embedding (gemma2-2b), as the reference does: MFU
(``model_flops / (step_s x PEAK_FLOPS_BF16)``) follows the reference's
numerator.
"""
from __future__ import annotations

import dataclasses

from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

# c10d op name -> the reference's HLO collective kind
COLLECTIVE_KINDS = {
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_volume(kind: str, group_size: int, buffer_bytes: float
                      ) -> float:
    """The reference's ring volume of one collective: its largest buffer
    x (m-1)/m, twice that for an all-reduce; a ring hop
    (``collective-permute``, one ``send``) moves its whole buffer."""
    if kind == "collective-permute":
        return float(buffer_bytes)
    m = group_size
    ring = (m - 1) / m if m > 1 else 0.0
    return buffer_bytes * ring * (2.0 if kind == "all-reduce" else 1.0)


def collective_stats(collectives) -> CollectiveStats:
    """``CollectiveStats`` of a dry run's collectives, ``(kind, group
    size, largest buffer bytes)`` each (``StepRecord.collectives``)."""
    counts: dict[str, int] = {}
    by_kind: dict[str, float] = {}
    for kind, m, buf in collectives:
        counts[kind] = counts.get(kind, 0) + 1
        by_kind[kind] = by_kind.get(kind, 0.0) + collective_volume(
            kind, m, buf)
    return CollectiveStats(counts, by_kind)


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (training) with N_active for MoE; 2*N*D for a
    forward-only step (prefill/decode)."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Per-token active parameter count from the config (the reference's:
    its ``2 V D`` counts a tied head twice)."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.hd
    attn = D * (cfg.n_heads * hd) * 2 + D * (cfg.n_kv_heads * hd) * 2
    glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    if cfg.n_experts:
        ffn = cfg.top_k * glu * D * F + D * cfg.n_experts  # + router
    else:
        ffn = glu * D * F
    return _per_layer(cfg, attn, ffn) * (cfg.n_layers + cfg.encoder_layers) \
        + 2 * V * D


def total_params(cfg) -> float:
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.hd
    attn = D * (cfg.n_heads * hd) * 2 + D * (cfg.n_kv_heads * hd) * 2
    glu = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    if cfg.n_experts:
        ffn = cfg.n_experts * glu * D * F + D * cfg.n_experts
    else:
        ffn = glu * D * F
    return _per_layer(cfg, attn, ffn) * (cfg.n_layers + cfg.encoder_layers) \
        + 2 * V * D


def _per_layer(cfg, attn, ffn):
    D = cfg.d_model
    if cfg.arch_type == "ssm":
        # mLSTM projections dominate
        return 5 * D * D
    if cfg.arch_type == "hybrid":
        d_in = cfg.n_heads * cfg.hd
        return attn + ffn + 2 * D * 2 * d_in
    return attn + ffn


def mfu(cfg, shape, step_s: float, peak: float = PEAK_FLOPS_BF16) -> float:
    """Model FLOPs utilisation of one step of ``shape`` that took
    ``step_s`` seconds: ``model_flops / (step_s x peak)``, the card's dense
    bf16 peak by default."""
    return model_flops(cfg, shape) / (step_s * peak)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compile_ok: bool
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    collective_bytes: float = 0.0
    temp_bytes: float = 0.0
    arg_bytes: float = 0.0
    coll_counts: dict = dataclasses.field(default_factory=dict)
    model_flops: float = 0.0
    # plan-predicted wire bytes for BOTH comm directions (the resolved
    # ShardingPlan's codec accounting: parameter all-gather payload and
    # gradient reduce-scatter payload)
    gather_wire_bytes: float = 0.0
    reduce_wire_bytes: float = 0.0
    error: str = ""
    note: str = ""

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "ok": self.compile_ok,
            "t_compute_s": round(self.t_compute, 6),
            "t_memory_s": round(self.t_memory, 6),
            "t_collective_s": round(self.t_collective, 6),
            "dominant": self.dominant if self.compile_ok else "-",
            "hlo_gflops_dev": round(self.flops_per_device / 1e9, 3),
            "hbm_gb_dev": round(self.bytes_per_device / 1e9, 3),
            "coll_gb_dev": round(self.collective_bytes / 1e9, 4),
            "temp_gb_dev": round(self.temp_bytes / 1e9, 3),
            "arg_gb_dev": round(self.arg_bytes / 1e9, 3),
            "gather_wire_mb": round(self.gather_wire_bytes / 1e6, 3),
            "reduce_wire_mb": round(self.reduce_wire_bytes / 1e6, 3),
            "model_gflops": round(self.model_flops / 1e9, 1),
            "useful_ratio": round(self.useful_ratio, 4),
            "colls": self.coll_counts,
            "note": self.note or self.error[:200],
        }


def analyze(record, *, arch, shape_cfg, mesh_name, chips, cfg, note="",
            plan=None) -> Roofline:
    """The ``Roofline`` of a dry run's ``StepRecord`` (the reference's
    ``analyze`` of a compiled executable): its FLOPs, bytes, collectives,
    temporary peak and argument bytes; ``plan`` adds the wire bytes."""
    stats = collective_stats(record.collectives)
    return Roofline(
        gather_wire_bytes=float(plan.gather_wire_bytes()) if plan else 0.0,
        reduce_wire_bytes=float(plan.reduce_wire_bytes()) if plan else 0.0,
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        compile_ok=True,
        flops_per_device=float(record.flops),
        bytes_per_device=float(record.bytes),
        collective_bytes=stats.total_bytes,
        temp_bytes=float(record.temp_peak),
        arg_bytes=float(record.arg_bytes),
        coll_counts=stats.counts,
        model_flops=model_flops(cfg, shape_cfg),
        note=note,
    )
