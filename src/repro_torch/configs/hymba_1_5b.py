"""Hymba-1.5B [arXiv:2411.13676]: 32L, d_model=1600, 25H (GQA kv=5),
d_ff=5504, vocab=32001, ssm_state=16; parallel attention + Mamba heads,
sliding-window attention except 3 global layers (meta tokens omitted)."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    arch_type="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001, head_dim=64,
    ssm_state=16, conv_kernel=4, sliding_window=1024,
    source="[arXiv:2411.13676]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
