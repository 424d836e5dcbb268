"""PyTorch + CUDA port of the veScale-FSDP reproduction (the JAX package
``repro`` is the reference)."""
