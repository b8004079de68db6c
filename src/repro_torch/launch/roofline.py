"""Roofline terms of a kernel or a step on the H100, and useful-FLOPs accounting.

Counterpart of ``repro/launch/roofline.py``, recast for the card:

    compute term    = FLOPs      / peak FLOP/s of the operands' type
    memory term     = bytes      / HBM bandwidth
    collective term = coll bytes / NVLink bandwidth (one direction)

and the bound is the largest term.  :meth:`HW.h100_sxm` holds NVIDIA's
published figures for the H100 SXM5 80GB at 700 W (dense tensor-core rates,
no sparsity): 989.4 TFLOP/s bf16, 494.7 TFLOP/s TF32, 66.9 TFLOP/s f32 on
the CUDA cores, 3.35 TB/s of HBM3 and 450 GB/s of NVLink a direction.  A
card set below 700 W runs slower under load, so a share of this bound is
read beside the card's power limit.

The reference's ``compiled_cost`` and ``collective_bytes`` read XLA's
artifacts and have no counterpart: ``obs.profile.profile_fn`` measures what
the first did (FLOPs from ``torch.utils.flop_counter``, device time and
peak memory).  The port's collectives are counted where they are issued:
the expert-parallel MoE's all-reduces in ``models.moe.EP_STATS`` (calls,
bytes, host seconds); DTensor's own collectives in the sharded train step
are not counted.  :func:`model_flops` is pure arithmetic, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["HW", "H100_SXM", "Roofline", "model_flops"]


@dataclass(frozen=True)
class HW:
    peak_flops: float = 989.4e12      # bf16 dense tensor-core FLOP/s
    hbm_bw: float = 3.35e12           # bytes/s
    link_bw: float = 450e9            # NVLink bytes/s, one direction
    tf32_flops: float = 494.7e12      # TF32 dense tensor-core FLOP/s
    f32_flops: float = 66.9e12        # f32 FLOP/s on the CUDA cores
    name: str = "H100 SXM5 80GB, 700 W"

    @staticmethod
    def h100_sxm() -> "HW":
        """NVIDIA's published H100 SXM5 80GB figures at 700 W."""
        return HW()

    def peak(self, dtype: str = "bf16") -> float:
        """Peak FLOP/s for operands of ``dtype`` ("bf16", "tf32" or "f32")."""
        return {"bf16": self.peak_flops, "tf32": self.tf32_flops,
                "f32": self.f32_flops}[dtype]


H100_SXM = HW.h100_sxm()


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                   # FLOPs a device (the name kept from the reference)
    hlo_bytes: float                   # bytes a device reads and writes
    coll_bytes: float                  # collective bytes a device
    coll_breakdown: dict = field(default_factory=dict)
    bytes_per_device: float = 0.0      # peak device memory
    model_flops: float = 0.0           # 6*N*D useful FLOPs (global)
    hw: HW = H100_SXM
    dtype: str = "bf16"                # the operands' type: sets the compute peak

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / self.hw.peak(self.dtype)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        """MODEL_FLOPS / (FLOPs x chips): how much of the counted work is useful."""
        tot = self.hlo_flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU upper bound: useful flops / (chips*peak*t_bound)."""
        denom = self.chips * self.hw.peak(self.dtype) * self.t_bound
        return self.model_flops / denom if denom else 0.0


def model_flops(cfg, shape, n_params_active: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for training, 2*N*D for a forward-only shape,
    with N = active params (MoE: routed active + shared + dense)."""
    tokens = shape.global_batch * shape.seq_len
    if kind == "train":
        return 6.0 * n_params_active * tokens
    if kind == "prefill":
        return 2.0 * n_params_active * tokens
    # decode: one new token per sequence
    return 2.0 * n_params_active * shape.global_batch
