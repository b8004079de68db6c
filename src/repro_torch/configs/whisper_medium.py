"""whisper-medium [audio]: enc-dec, 24+24L, d=1024, 16H (kv=16), ff=4096,
vocab=51865.  Conv frontend is a STUB: input_specs() supplies precomputed frame
embeddings (1500 frames).  [arXiv:2212.04356; unverified]"""

from .base import EncoderConfig, ModelConfig, StageConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=4096,
    vocab=51865,
    stages=(StageConfig(repeats=24, layers=(("attn_x", "dense"),)),),
    encoder=EncoderConfig(n_layers=24, n_ctx=1500),
    act="gelu",
    pos_encoding="sinusoid",
    source="[arXiv:2212.04356; unverified]",
)
