"""kimi-k2-1t-a32b [moe]: trillion-param MoE, 61L (1 dense + 60 MoE), d=7168,
64H (GQA kv=8), expert ff=2048, MoE 384e top-8 + 1 shared, vocab=163840.
Paper-table config; adafactor + FSDP are mandatory at this scale.
[arXiv:2501.kimi2; unverified]"""

from .base import ModelConfig, MoEConfig, StageConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_heads=64,
    kv_heads=8,
    d_ff=18432,                    # dense (first-layer) FFN width
    vocab=163840,
    stages=(
        StageConfig(repeats=1, layers=(("attn", "dense"),)),
        StageConfig(repeats=60, layers=(("attn", "moe"),)),
    ),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048, n_shared=1),
    optimizer="adafactor",
    use_fsdp=True,
    source="[arXiv:2501.kimi2; unverified]",
)
