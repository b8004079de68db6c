"""Architecture + shape configuration dataclasses.

A model is a sequence of *stages*; each stage is a scan over ``repeats`` copies of
a *super-block*, and a super-block is an ordered list of ``(mixer, mlp)`` layers.
Mixers: ``attn`` (causal GQA), ``attn_nc`` (non-causal, encoder), ``attn_x``
(self + cross, whisper decoder), ``xattn`` (cross-attn only, VLM image layers),
``mla`` (DeepSeek latent attention), ``mamba`` (Mamba-2 SSD).
MLPs: ``dense``, ``moe``, ``none``.

Heterogeneous patterns (Jamba 1:7, VLM every-5th-cross) are expressed inside the
super-block.  Counterpart of ``repro/configs/base.py``, copied: plain data.  The
port runs every mixer and MLP kind above; its model loops over ``repeats`` in
Python.  Of the runtime-policy fields, ``remat`` is read (a training pass
recomputes each repeat in the backward), ``optimizer`` picks the train
step's optimizer, and the attention chunks set the blocks of the model's
blockwise attention (``models.attention.chunked_attention``, the K7 train
step's backward), as in the reference; ``causal_block_skip`` and
``unroll_loops``, which steer XLA, are kept for the configs' sake and not
read (the blockwise attention always skips the fully masked causal blocks,
which changes no bit).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

__all__ = [
    "MoEConfig",
    "MLAConfig",
    "SSMConfig",
    "EncoderConfig",
    "StageConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
]

Layer = tuple[str, str]  # (mixer, mlp)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder consuming precomputed frame embeddings (stub frontend)."""

    n_layers: int
    n_ctx: int = 1500              # frames after the (stubbed) conv frontend


@dataclass(frozen=True)
class StageConfig:
    repeats: int
    layers: tuple[Layer, ...]

    @property
    def n_layers(self) -> int:
        return self.repeats * len(self.layers)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    stages: tuple[StageConfig, ...]
    head_dim: int | None = None
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    n_img_tokens: int = 0          # VLM: precomputed patch-embedding count (stub)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"            # swiglu | gelu
    pos_encoding: str = "rope"     # rope | sinusoid | none
    tie_embeddings: bool = False
    mtp: bool = False              # DeepSeek-style multi-token-prediction head
    mtp_weight: float = 0.1
    max_seq: int = 8192            # RoPE table length; overridden per shape
    # -- runtime policy -----------------------------------------------------
    remat: bool = True
    optimizer: str = "adamw"       # adamw | adafactor (huge models)
    use_fsdp: bool = False
    shard_heads: bool = True       # False when n_heads doesn't divide the TP axis
    shard_ssm: bool = True         # False when SSM inner dims don't divide TP
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    causal_block_skip: bool = True   # skip fully-masked KV blocks (perf opt P1)
    # Cost-probe mode: every lax.scan / lax.map becomes a Python loop so XLA
    # cost_analysis counts every iteration (while bodies are counted ONCE by
    # XLA) -- used only by launch/costprobe.py, never for real execution.
    unroll_loops: bool = False
    source: str = ""               # provenance note [arXiv/hf; tier]

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        scale_stages = tuple(
            StageConfig(repeats=min(s.repeats, 2), layers=s.layers) for s in self.stages
        )
        moe = (
            replace(self.moe, n_experts=min(self.moe.n_experts, 8),
                    top_k=min(self.moe.top_k, 2), d_ff_expert=64)
            if self.moe else None
        )
        mla = (
            MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16)
            if self.mla else None
        )
        ssm = (
            replace(self.ssm, d_state=16, head_dim=8, chunk=16) if self.ssm else None
        )
        enc = EncoderConfig(n_layers=2, n_ctx=16) if self.encoder else None
        return replace(
            self,
            name=self.name + "-smoke",
            d_model=64,
            n_heads=4,
            kv_heads=min(self.kv_heads, 2) if self.kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            stages=scale_stages,
            moe=moe,
            mla=mla,
            ssm=ssm,
            encoder=enc,
            n_img_tokens=8 if self.n_img_tokens else 0,
            max_seq=64,
            attn_q_chunk=16,
            attn_kv_chunk=16,
            use_fsdp=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
