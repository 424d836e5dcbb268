"""Qwen2.5-14B, the published model card hf:Qwen/Qwen2.5-14B: 48L,
d_model=5120, 40 heads (GQA kv=8), head_dim 128, d_ff=13824,
vocab=152064, QKV bias, untied head -- the model of the paper's Fig. 10(b)
Muon run (the reference's ``examples/muon_demo.py``).  The fields are the
reference's ``configs/qwen2_5_14b.py`` verbatim, ``source`` included: that
string names the family's 0.5B card, but the widths are the 14B card's."""
from .base import ModelConfig, ParallelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, mlp="swiglu", rope_theta=1e6,
    source="[hf:Qwen/Qwen2.5-0.5B]",
    parallel=ParallelConfig(fsdp_axes=("data", "model"),
                            batch_axes=("data", "model")),
    optimizer="adamw",
)
