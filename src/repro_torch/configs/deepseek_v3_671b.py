"""deepseek-v3-671b [moe]: 61L (3 dense + 58 MoE), d=7168, 128H MLA,
expert ff=2048, 1 shared + 256 routed top-8, vocab=129280, MTP head.
MLA runs in absorbed/MQA form (see models.attention).  [arXiv:2412.19437; hf]"""

from .base import MLAConfig, ModelConfig, MoEConfig, StageConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    d_model=7168,
    n_heads=128,
    kv_heads=128,                  # per assignment; MLA replaces per-head KV
    d_ff=18432,                    # dense (first-3-layer) FFN width
    vocab=129280,
    stages=(
        StageConfig(repeats=3, layers=(("mla", "dense"),)),
        StageConfig(repeats=58, layers=(("mla", "moe"),)),
    ),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    mtp=True,
    optimizer="adafactor",
    use_fsdp=True,
    source="[arXiv:2412.19437; hf]",
)
