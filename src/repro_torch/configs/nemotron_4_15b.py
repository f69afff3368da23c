"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",
    norm="rmsnorm",
    qkv_bias=False,
    rope="full",
)
