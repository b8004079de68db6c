"""Constraint-dominance counts, kernel K3, beside its plain version.

``dominance_counts`` replaces ``repro/kernels/moo_kernels.py::
dominance_counts_pallas``; the CUDA source is ``csrc/moo_kernels.cu``, whose
header says what bounds it on the H100.  For every point it returns the
number of *active* points that constraint-dominate it (``moo.
fast_nondominated_sort``'s rule): j dominates i iff both are feasible
(``viol <= 0``) and j Pareto-dominates i, or j is feasible and i is not, or
both are infeasible and ``viol_j < viol_i``.

The plain version is the column sums of :func:`dominance_matrix` over the
active rows.  On a CPU tensor the wrapper returns it; on a CUDA tensor it
launches the kernel or raises.  ``dominance_counts.launches`` counts kernel
launches.  Any P is accepted (the kernel masks its ragged last tile); rows
padded with inactive +inf-violation points are never counted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["dominance_matrix", "dominance_counts_plain", "dominance_counts"]

MAX_OBJ = 4  # objective registers per thread in the kernel


def dominance_matrix(objs: torch.Tensor, viol: torch.Tensor) -> torch.Tensor:
    """(n, n) bool, ``[i, j]`` = i constraint-dominates j."""
    le = (objs[:, None, :] <= objs[None, :, :]).all(-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(-1)
    fi = viol <= 0
    dom = (fi[:, None] & fi[None, :]) & (le & lt)
    dom |= fi[:, None] & ~fi[None, :]
    dom |= (~fi[:, None] & ~fi[None, :]) & (viol[:, None] < viol[None, :])
    return dom


def dominance_counts_plain(objs: torch.Tensor, viol: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (P,) int32 counts of active dominators."""
    return (dominance_matrix(objs, viol) & active[:, None]).sum(0, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("moo_kernels")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dominance_counts_launch.argtypes = [p, p, p, p, i, i, p]
    lib.dominance_counts_launch.restype = ctypes.c_int
    return lib


def dominance_counts(objs: torch.Tensor, viol: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """K3: objs (P, n_obj) f32, viol (P,) f32, active (P,) bool -> (P,) int32."""
    if objs.dim() != 2:
        raise ValueError(f"objs must be (P, n_obj), got {tuple(objs.shape)}")
    p, n_obj = objs.shape
    for t, name, dtype, shape in (
        (objs, "objs", torch.float32, (p, n_obj)),
        (viol, "viol", torch.float32, (p,)),
        (active, "active", torch.bool, (p,)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != objs.device:
            raise ValueError(f"{name} is on {t.device}, expected {objs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if objs.device.type == "cpu":
        return dominance_counts_plain(objs, viol, active)
    if objs.device.type != "cuda":
        raise ValueError(f"unsupported device {objs.device}")
    if not 1 <= n_obj <= MAX_OBJ:
        raise ValueError(f"the kernel takes 1..{MAX_OBJ} objectives, got {n_obj}")
    out = torch.empty(p, dtype=torch.int32, device=objs.device)
    if p == 0:
        return out
    stream = torch.cuda.current_stream(objs.device).cuda_stream
    err = _lib().dominance_counts_launch(
        objs.data_ptr(), viol.data_ptr(), active.data_ptr(), out.data_ptr(),
        p, n_obj, stream,
    )
    if err != 0:
        raise RuntimeError(f"dominance_counts launch failed: cudaError {err}")
    dominance_counts.launches += 1
    return out


dominance_counts.launches = 0
