"""GPT-OSS-120B [arXiv:2508.10925] -- the paper's MoE evaluation model
(Fig. 8, Table 1): 36L, d_model=2880, 64H (GQA kv=8), 128 experts top-4,
d_ff=2880/expert, vocab=201088.  EP=16 over the model axis (experts
Shard(0) then RaggedShard); a run on fewer ranks sets ``ep`` to the model
axis it has."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="gpt-oss-120b",
    arch_type="moe",
    n_layers=36, d_model=2880, n_heads=64, n_kv_heads=8,
    d_ff=2880, vocab=201088, head_dim=64,
    n_experts=128, top_k=4,
    source="[arXiv:2508.10925]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model"), ep=16),
    optimizer="adamw",
)
