"""internvl2-1b [vlm] — InternViT + Qwen2-0.5B LM backbone [arXiv:2404.16821].

The ViT/projector frontend is a stub per the task carve-out: the LM consumes
precomputed patch embeddings (B, n_patches, d_model) as a soft prefix.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,               # qwen2-style attention biases
    rope="full",
    rope_theta=1e6,
    n_patches=1024,
)
