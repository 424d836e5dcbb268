"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L,
d_model=1024, 16H (GQA kv=8), 32 experts top-8, d_ff=512/expert,
vocab=49155."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155, head_dim=64,
    n_experts=32, top_k=8,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
