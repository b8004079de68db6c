"""deepseek-67b [dense]: llama-arch, 95L, d=8192, 64H (GQA kv=8), ff=22016,
vocab=102400.  [arXiv:2401.02954; hf]"""

from .base import ModelConfig, StageConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22016,
    vocab=102400,
    stages=(StageConfig(repeats=95, layers=(("attn", "dense"),)),),
    use_fsdp=True,
    source="[arXiv:2401.02954; hf]",
)
