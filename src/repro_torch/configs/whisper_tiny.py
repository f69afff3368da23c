"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub: the encoder takes
precomputed frame embeddings (B, 1500, 384).  Decoder positions use
sinusoids (whisper's learned table is an init detail).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=4,                   # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,                 # MHA (kv == q heads)
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope="none",
    n_frames=1500,                # 30 s of audio at 50 Hz after conv stride
)
