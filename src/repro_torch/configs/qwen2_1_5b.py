"""qwen2-1.5b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="full",
    rope_theta=1e6,
    tie_embeddings=True,
)
