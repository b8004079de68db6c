"""internlm2-1.8b [dense]: 24L, d=2048, 16H (GQA kv=8), ff=8192, vocab=92544.
[arXiv:2403.17297; hf]"""

from .base import ModelConfig, StageConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    d_model=2048,
    n_heads=16,
    kv_heads=8,
    d_ff=8192,
    vocab=92544,
    stages=(StageConfig(repeats=24, layers=(("attn", "dense"),)),),
    source="[arXiv:2403.17297; hf]",
)
