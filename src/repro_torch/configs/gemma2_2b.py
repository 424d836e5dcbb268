"""Gemma2-2B [arXiv:2408.00118]: 26L, d_model=2304, 8H (GQA kv=4),
d_ff=9216, vocab=256000; alternating local(4096)/global attention, attn +
final logit softcaps, GeGLU, post-norms, tied embeddings."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    mlp="geglu", attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global_alternate=True, post_norms=True,
    tie_embeddings=True, rope_theta=10000.0,
    source="[arXiv:2408.00118]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
