"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, 16e top-2 MoE
[arXiv:2403.19887].

Block period 8: one attention layer (index 4) per 7 mamba mixers; the MLP is
MoE on every second layer (16 experts, top-2), dense otherwise.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, MoEConfig, SSMConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    activation="swiglu",
    norm="rmsnorm",
    rope="full",
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    hybrid=HybridConfig(period=8, attn_index=4),
)
