"""Qwen1.5-32B, after the published model card hf:Qwen/Qwen1.5-32B: 64L,
d_model=5120, 40H, d_ff=27392, vocab=152064, QKV bias.  The fields are the
reference's ``configs/qwen1_5_32b.py`` verbatim, ``source`` included (it
names the family's 0.5B card).  One departs from the published card and is
kept for parity with the reference: kv=40 heads (multi-head attention),
where Qwen1.5-32B uses grouped-query attention with 8 KV heads."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064, head_dim=128,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    source="[hf:Qwen/Qwen1.5-0.5B]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
