"""starcoder2-3b [dense]: 30L, d=3072, 24H (GQA kv=2), ff=12288, vocab=49152,
GQA + RoPE.  24 heads don't divide a 16-way TP axis -> heads replicated
(shard_heads=False); mlp/vocab still TP-sharded.  [arXiv:2402.19173; hf]"""

from .base import ModelConfig, StageConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    n_heads=24,
    kv_heads=2,
    d_ff=12288,
    vocab=49152,
    stages=(StageConfig(repeats=30, layers=(("attn", "dense"),)),),
    act="gelu",
    rope_theta=100_000.0,
    shard_heads=False,
    source="[arXiv:2402.19173; hf]",
)
