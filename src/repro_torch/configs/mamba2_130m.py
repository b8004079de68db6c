"""mamba2-130m [ssm]: attention-free SSD, 24L, d=768, vocab=50280,
ssm_state=128.  Blocks are mamba-only (no separate MLP), tied embeddings.
SSM inner dims (d_in_proj=3352) don't divide a 16-way TP axis -> the 130M
model's SSM weights stay replicated (shard_ssm=False).
[arXiv:2405.21060; unverified]"""

from .base import ModelConfig, SSMConfig, StageConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768,
    n_heads=12,          # unused by the SSD mixer; kept for head-dim accounting
    kv_heads=12,
    d_ff=0,
    vocab=50280,
    stages=(StageConfig(repeats=24, layers=(("mamba", "none"),)),),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    pos_encoding="none",
    tie_embeddings=True,
    shard_ssm=False,
    source="[arXiv:2405.21060; unverified]",
)
