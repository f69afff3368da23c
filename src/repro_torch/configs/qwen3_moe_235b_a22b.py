"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=151936,
    activation="swiglu",
    norm="rmsnorm",
    rope="full",
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, every=1),
)
