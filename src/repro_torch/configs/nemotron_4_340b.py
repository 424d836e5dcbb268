"""Nemotron-4-340B [arXiv:2402.16819]: 96L, d_model=18432, 96H (GQA kv=8),
d_ff=73728, vocab=256000, squared-ReLU MLP.  TP=16 x FSDP=16 with sequence
parallelism and gradient accumulation (16 microbatches); 8-bit Adam (the
paper's block-wise quantized optimizer) keeps the 340B optimizer state
small.  The reference's fields, one for one."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, head_dim=192,
    mlp="squared_relu",
    source="[arXiv:2402.16819]",
    parallel=ParallelConfig(fsdp_axes=("data",), batch_axes=("data",),
                            tp=16, sequence_parallel=True, microbatches=16),
    optimizer="adam8bit",
)
