"""Qwen3-235B-A22B [hf:Qwen/Qwen3-30B-A3B family scaled per assignment]:
94L, d_model=4096, 64H (GQA kv=4), 128 experts top-8, d_ff=1536/expert,
vocab=151936.  EP=16 over the model axis in the reference (experts
Shard(0) then RaggedShard, the paper's Fig. 5 composition; the port runs
ep=1 until ROADMAP Queue 1 item 18); 8-bit Adam for the optimizer states."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    n_experts=128, top_k=8,
    source="[hf:Qwen/Qwen3-30B-A3B]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model"), ep=16),
    optimizer="adam8bit",
)
