"""jamba-v0.1-52b [hybrid]: 32L = 4 x (8-layer block: 7 mamba + 1 attn at index
4), MoE 16e top-2 on every other layer, d=4096, 32H (GQA kv=8), ff=14336,
vocab=65536.  No positional encoding (Mamba layers carry position).
[arXiv:2403.19887; hf]"""

from .base import ModelConfig, MoEConfig, SSMConfig, StageConfig

_BLOCK = tuple(
    ("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=65536,
    stages=(StageConfig(repeats=4, layers=_BLOCK),),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    pos_encoding="none",
    use_fsdp=True,
    source="[arXiv:2403.19887; hf]",
)
