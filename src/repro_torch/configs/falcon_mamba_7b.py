"""falcon-mamba-7b [ssm] — attention-free mamba1 [arXiv:2410.05355]."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355",
    n_layers=64,
    d_model=4096,
    n_heads=1,                    # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,                       # mamba1 blocks have no separate MLP
    vocab_size=65024,
    norm="rmsnorm",
    rope="none",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
