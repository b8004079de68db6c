"""llama-3.2-vision-90b [vlm]: 100L = 20 x (4 self-attn + 1 gated cross-attn to
image tokens), d=8192, 64H (GQA kv=8), ff=28672, vocab=128256.  Vision tower is
a STUB: input_specs() supplies precomputed patch embeddings (1600 tokens).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from .base import ModelConfig, StageConfig

_BLOCK = (
    ("attn", "dense"),
    ("attn", "dense"),
    ("attn", "dense"),
    ("attn", "dense"),
    ("xattn", "dense"),
)

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=28672,
    vocab=128256,
    stages=(StageConfig(repeats=20, layers=_BLOCK),),
    n_img_tokens=1600,
    rope_theta=500_000.0,
    optimizer="adafactor",
    use_fsdp=True,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
