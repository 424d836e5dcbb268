"""xLSTM-125M [arXiv:2405.04517]: 12L, d_model=768, 4 heads, vocab=50304;
sLSTM + mLSTM blocks (one sLSTM per 6-block super-block here; stabilized
sigmoid gating -- DESIGN.md)."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=192,
    slstm_every=6,
    source="[arXiv:2405.04517]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
