"""SeamlessM4T-medium [arXiv:2308.11596]: enc-dec transformer backbone,
12 encoder + 12 decoder layers, d_model=1024, 16H, d_ff=4096, vocab=256206.
Audio frontend stubbed to frame embeddings (assignment carve-out)."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12, encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64, n_frames=4096,
    mlp="swiglu",
    source="[arXiv:2308.11596]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
