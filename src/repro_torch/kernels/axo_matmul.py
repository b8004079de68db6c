"""The AxO matmul, kernel K6, beside its plain version.

``axo_matmul`` replaces ``repro/kernels/axo_matmul_kernel.py::
axo_matmul_pallas`` as the reference's ``ops.axo_matmul`` calls it: from
operand codes.  The CUDA source is ``csrc/axo_matmul.cu``, whose header says
what bounds it on the H100 and how the design answers it.  For n-bit codes
a (M, K) and b (K, N) it computes, in IEEE f32,

    out = sv[a] @ sv[b] + sum_r f[a, r] @ g[b, r]                  (M, N)

with ``sv`` the signed value of each code and ``f``, ``g`` the rank-R factors
of the operator's error table (``axo.deploy.AxOOperator``).  The kernel
gathers values and factors from the ``(2^n,)`` and ``(2^n, R)`` tables
itself, so a caller keeps its weights as 1-byte codes.

The plain version gathers the values and factors and runs ``torch.matmul``
in f32: one product for the exact part, then one per rank.  On a CPU tensor
the wrapper returns it; on a CUDA tensor it launches the kernel or raises.
``axo_matmul.launches`` counts kernel launches.  Any M, K and N work: the
kernel masks its ragged tiles itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["axo_matmul", "axo_matmul_plain", "plan"]

MAX_SMEM = 227 * 1024      # dynamic shared memory one block may use
SMALL_M = 16               # M at or below this takes the 16-row tile
WAVE_BLOCKS = 2 * 132      # split K until the grid holds two blocks per SM
MIN_SPLIT_K = 256          # codes of K per split, at least


def _need_ieee_f32(t: torch.Tensor) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the AxO matmul needs IEEE f32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is True")


def axo_matmul_plain(a_codes: torch.Tensor, b_codes: torch.Tensor, f_table: torch.Tensor,
                     g_table: torch.Tensor, signed_vals: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: gathers, then f32 ``torch.matmul`` -> (M, N) f32."""
    _need_ieee_f32(a_codes)
    a = a_codes.long()
    b = b_codes.long()
    out = signed_vals[a] @ signed_vals[b]
    for r in range(f_table.shape[1]):
        out += f_table[:, r][a] @ g_table[:, r][b]
    return out


def plan(m: int, n: int, k: int, rank: int, n_codes: int) -> tuple[int, int, int, int]:
    """(tile rows, splits of K, codes per split, shared-memory bytes) of a launch."""
    bm = SMALL_M if m <= SMALL_M else 64
    blocks = -(-n // 64) * -(-m // bm)
    splits = 1
    if blocks < WAVE_BLOCKS:
        splits = max(1, min(-(-WAVE_BLOCKS // blocks), k // MIN_SPLIT_K))
    k_split = -(-k // splits)
    k_split = -(-k_split // 8) * 8          # whole shared-memory steps per split
    splits = -(-k // k_split) if k else 1
    r1 = rank + 1
    ts = (n_codes + 3) // 4 * 4
    smem = (2 * r1 * ts + r1 * 8 * (bm + 64)) * 4
    return bm, splits, k_split, smem


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("axo_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.axo_matmul_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.axo_matmul_launch.restype = ctypes.c_int
    return lib


def _check(a_codes, b_codes, f_table, g_table, signed_vals) -> None:
    for name, t, ndim, dtype in (("a_codes", a_codes, 2, torch.uint8),
                                 ("b_codes", b_codes, 2, torch.uint8),
                                 ("f_table", f_table, 2, torch.float32),
                                 ("g_table", g_table, 2, torch.float32),
                                 ("signed_vals", signed_vals, 1, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
        if t.device != a_codes.device:
            raise ValueError(f"{name} is on {t.device}, expected {a_codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a_codes.shape[1] != b_codes.shape[0]:
        raise ValueError(f"a_codes (M, K) {tuple(a_codes.shape)} and b_codes (K, N) "
                         f"{tuple(b_codes.shape)} disagree on K")
    n_codes = signed_vals.shape[0]
    if n_codes & (n_codes - 1) or not 4 <= n_codes <= 256:
        raise ValueError(f"tables must have 2^n rows, 2 <= n <= 8, got {n_codes}")
    if f_table.shape != g_table.shape or f_table.shape[0] != n_codes:
        raise ValueError(f"f_table {tuple(f_table.shape)} and g_table "
                         f"{tuple(g_table.shape)} must both be ({n_codes}, R)")


def axo_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor, f_table: torch.Tensor,
               g_table: torch.Tensor, signed_vals: torch.Tensor) -> torch.Tensor:
    """K6: uint8 codes (M, K), (K, N); f32 tables (2^n, R), (2^n, R), (2^n,) -> (M, N) f32."""
    _check(a_codes, b_codes, f_table, g_table, signed_vals)
    if a_codes.device.type == "cpu":
        return axo_matmul_plain(a_codes, b_codes, f_table, g_table, signed_vals)
    (m, k), n = a_codes.shape, b_codes.shape[1]
    rank, n_codes = f_table.shape[1], signed_vals.shape[0]
    if m * n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a_codes.device)
    bm, splits, k_split, smem = plan(m, n, k, rank, n_codes)
    if smem > MAX_SMEM:
        raise ValueError(f"rank {rank} needs {smem} bytes of shared memory per block, "
                         f"over {MAX_SMEM}")
    out = torch.empty((m, n), dtype=torch.float32, device=a_codes.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a_codes.device)
          if splits > 1 else out)
    stream = torch.cuda.current_stream(a_codes.device).cuda_stream
    err = _lib().axo_matmul_launch(
        a_codes.data_ptr(), b_codes.data_ptr(), signed_vals.data_ptr(), f_table.data_ptr(),
        g_table.data_ptr(), out.data_ptr(), ws.data_ptr(), m, n, k, rank, n_codes, bm,
        splits, k_split, stream,
    )
    if err != 0:
        raise RuntimeError(f"axo_matmul launch failed: cudaError {err}")
    axo_matmul.launches += 1
    return out


axo_matmul.launches = 0
