"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision]: 100L,
d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256; cross-attention
image layers every 5th layer.  Vision frontend is a stub: input_specs
provides patch embeddings (assignment carve-out)."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    mlp="swiglu", cross_attn_interval=5, n_patches=1024, rope_theta=5e5,
    source="[hf:meta-llama/Llama-3.2-11B-Vision]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
