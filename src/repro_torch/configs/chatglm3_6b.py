"""chatglm3-6b [dense] — 2d (partial) RoPE, GQA [arXiv:2406.12793]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope="partial",               # chatglm 2d rope: half the head dim rotates
    rope_fraction=0.5,
)
