"""LLaMA-3-70B [arXiv:2407.21783] -- the paper's dense evaluation model
(Fig. 8): 80L, d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="llama3-70b",
    arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    mlp="swiglu", rope_theta=5e5,
    source="[arXiv:2407.21783]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
