"""granite-3-2b [dense]: 40L, d=2048, 32H (GQA kv=8), ff=8192, vocab=49155,
tied embeddings.  [hf:ibm-granite/granite-3.0-2b-base; hf]"""

from .base import ModelConfig, StageConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    d_model=2048,
    n_heads=32,
    kv_heads=8,
    d_ff=8192,
    vocab=49155,
    stages=(StageConfig(repeats=40, layers=(("attn", "dense"),)),),
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-2b-base; hf]",
)
