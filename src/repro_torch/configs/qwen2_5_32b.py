"""qwen2.5-32b [dense] — GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="full",
    rope_theta=1e6,
)
