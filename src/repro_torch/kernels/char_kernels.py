"""BEHAV statistics kernels K1 (table) and K2 (entry), each beside its plain version.

``behav_stats_table`` replaces ``repro/kernels/char_kernels.py::
behav_stats_pallas`` and ``behav_stats_entry`` replaces
``behav_stats_entry_pallas``; the CUDA sources are ``csrc/char_kernels.cu``,
whose header says what bounds them on the H100 and how the design answers it.

Both return per-A-tile partials ``(A // a_tile, D, 8)`` in int32 and f32:

  int32: 0 sum|e|   1 count(e != 0)   2 max|e|
         3 sum hi^2  4 sum hi*lo  5 sum lo^2    (hi = |e| >> 8, lo = |e| & 255)
  f32:   0 sum |e| * w

``a_tile`` must keep every int32 partial below 2^30
(``core.fastchar.default_a_tile``: 64 at 8 bits).

On a CPU tensor each wrapper returns its plain version, the tiling of the
reference's ``fastchar._partials_xla`` written in torch.  On a CUDA tensor it
launches the kernel or raises; it never falls back.  ``launches`` on each
wrapper counts kernel launches (plain-version calls do not count).

K1 walks each a-tile's codes in registers (a thread a b column, the plane
values of the tile's varying rows held per config); its first design, which
reads every product's planes from shared memory, stays callable as
``behav_stats_table_first`` for the comparison on the card, with a counter of
its own.  K2 runs the same walk with every plane value computed in closed
form from the config's masks and the exact product and weight from the
codes, 4 configs a thread, or 1 where a small D would leave SMs without a
block (:func:`entry_configs`; :func:`behav_stats_entry_at` runs either, for
their comparison on the card); its first design (planes synthesized into shared
memory by every (config, A-tile) block) stays callable as
``behav_stats_entry_first``.  ``tests/test_torch_kernel_design.py`` emulates
both walks.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.operator_model import _synth_small, spec_for
from . import build
from .registry import entry_configs

__all__ = [
    "N_CHAN",
    "behav_stats_table",
    "behav_stats_table_first",
    "behav_stats_table_plain",
    "behav_stats_entry",
    "behav_stats_entry_at",
    "behav_stats_entry_first",
    "behav_stats_entry_plain",
    "entry_configs",
]

N_CHAN = 8
MAX_BITS = 8    # (R, 4, B) planes in shared memory and int32 partials
PLAIN_D_BLOCK = 16  # configs per chunk of the plain version's (Db, A, B) tile


def behav_stats_table_plain(small, exact, w, a_tile, d_block=PLAIN_D_BLOCK):
    """Plain torch version of K1: ``small`` (R, D, 4, B) i32, ``exact`` (A, B)
    i32, ``w`` (A, B) f32 -> ((n_ta, D, 8) i32, (n_ta, D, 8) f32).

    Configs go in chunks of ``d_block`` so the (Db, A, B) error tile stays
    small; each chunk is reduced exactly as ``fastchar._partials_xla`` does.
    """
    rows, d, _, b = small.shape
    a = exact.shape[0]
    n_ta = a // a_tile
    codes = torch.arange(a, device=small.device)
    pair_idx = [
        2 * ((codes >> (2 * r)) & 1) + ((codes >> (2 * r + 1)) & 1)
        for r in range(rows)
    ]
    int_parts, rel_parts = [], []
    for lo_d in range(0, d, d_block):
        sm = small[:, lo_d:lo_d + d_block]                  # (R, Db, 4, B)
        db = sm.shape[1]
        approx = None
        for r in range(rows):
            term = sm[r][:, pair_idx[r], :] << (2 * r)      # (Db, A, B)
            approx = term if approx is None else approx + term
        err = approx - exact[None]
        abs_e = err.abs()
        hi = abs_e >> 8
        lo = abs_e & 255

        def ts(x):  # per-A-tile int32 sums, (n_ta, Db)
            return x.reshape(db, n_ta, -1).sum(-1, dtype=torch.int32).T

        mx = abs_e.reshape(db, n_ta, -1).amax(-1).T
        zero = torch.zeros_like(mx)
        int_parts.append(torch.stack(
            [ts(abs_e), ts((err != 0).to(torch.int32)), mx,
             ts(hi * hi), ts(hi * lo), ts(lo * lo), zero, zero], dim=-1,
        ))
        rel = (abs_e.to(torch.float32) * w[None]).reshape(db, n_ta, -1).sum(-1).T
        rel_p = torch.zeros(n_ta, db, N_CHAN, dtype=torch.float32, device=small.device)
        rel_p[..., 0] = rel
        rel_parts.append(rel_p)
    return torch.cat(int_parts, dim=1), torch.cat(rel_parts, dim=1)


def _entry_exact_and_weights(n_bits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's exact products and f32 weights ``1 / max(|exact|, 1)`` from the codes."""
    b = 1 << n_bits
    codes = torch.arange(b, dtype=torch.int32, device=device)
    sv = torch.where(codes >= b // 2, codes - b, codes)
    exact = sv[:, None] * sv[None, :]                       # (A, B) int32
    w = 1.0 / exact.abs().clamp(min=1).to(torch.float32)    # rn(1/x) in f32, as K2
    return exact, w


def behav_stats_entry_plain(masks, n_bits, a_tile, d_block=PLAIN_D_BLOCK):
    """Plain torch version of K2: (D, R) i32 masks -> K1's outputs.

    Planes come from the carry-chain synthesis (``operator_model.
    _synth_small``), exact products and weights from the codes, as in K2.
    """
    small = torch.stack(_synth_small(spec_for(n_bits), masks, torch, torch.int32))
    exact, w = _entry_exact_and_weights(n_bits, masks.device)
    return behav_stats_table_plain(small, exact, w, a_tile, d_block)


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_tiling(n_bits: int, a_tile: int) -> None:
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"BEHAV kernels take 1..{MAX_BITS}-bit operands, got {n_bits}")
    b = 1 << n_bits
    if a_tile < 1 or b % a_tile:
        raise ValueError(f"a_tile={a_tile} must divide A={b}")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("char_kernels")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("behav_stats_table_launch", "behav_stats_table_first_launch"):
        getattr(lib, name).argtypes = [p, p, p, p, p, i, i, i, i, p]
        getattr(lib, name).restype = ctypes.c_int
    lib.behav_stats_entry_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.behav_stats_entry_first_launch.argtypes = [p, p, p, i, i, i, i, p]
    for name in ("behav_stats_entry_launch", "behav_stats_entry_first_launch"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _outputs(n_ta: int, d: int, device):
    return (
        torch.empty((n_ta, d, N_CHAN), dtype=torch.int32, device=device),
        torch.empty((n_ta, d, N_CHAN), dtype=torch.float32, device=device),
    )


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _table_stats(launcher: str, small: torch.Tensor, exact: torch.Tensor, w: torch.Tensor,
                 a_tile: int):
    """(int partials, f32 partials, whether a kernel was launched) of K1's
    ``launcher`` design; the plain version on a CPU tensor."""
    rows, d, _, b = small.shape
    n_bits = b.bit_length() - 1
    if b != 1 << n_bits:
        raise ValueError(f"operand axis B={b} is not a power of two")
    _check_tiling(n_bits, a_tile)
    _check(small, "small", torch.int32, (rows, d, 4, b), small.device)
    _check(exact, "exact", torch.int32, (b, b), small.device)
    _check(w, "w", torch.float32, (b, b), small.device)
    if _device_kind(small) == "cpu":
        return (*behav_stats_table_plain(small, exact, w, a_tile), False)
    int_out, rel_out = _outputs(b // a_tile, d, small.device)
    if d == 0:
        return int_out, rel_out, False
    stream = torch.cuda.current_stream(small.device).cuda_stream
    _raise_on(getattr(_lib(), launcher)(
        small.data_ptr(), exact.data_ptr(), w.data_ptr(), int_out.data_ptr(),
        rel_out.data_ptr(), rows, d, n_bits, a_tile, stream,
    ), launcher)
    return int_out, rel_out, True


def behav_stats_table(small: torch.Tensor, exact: torch.Tensor, w: torch.Tensor,
                      a_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: per-A-tile BEHAV partials from gathered per-row planes."""
    int_out, rel_out, launched = _table_stats("behav_stats_table_launch", small, exact, w,
                                              a_tile)
    behav_stats_table.launches += launched
    return int_out, rel_out


def behav_stats_table_first(small: torch.Tensor, exact: torch.Tensor, w: torch.Tensor,
                            a_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's first design (products from shared-memory planes) on K1's inputs."""
    int_out, rel_out, launched = _table_stats("behav_stats_table_first_launch", small, exact,
                                              w, a_tile)
    behav_stats_table_first.launches += launched
    return int_out, rel_out


behav_stats_table.launches = 0
behav_stats_table_first.launches = 0


def _entry_stats(launcher: str, masks: torch.Tensor, n_bits: int, a_tile: int, *args: int):
    """(int partials, f32 partials, whether a kernel was launched) of K2's
    ``launcher`` design, ``args`` passed before the stream; the plain
    version on a CPU tensor."""
    _check_tiling(n_bits, a_tile)
    rows = spec_for(n_bits).rows
    d = masks.shape[0]
    _check(masks, "masks", torch.int32, (d, rows), masks.device)
    if _device_kind(masks) == "cpu":
        return (*behav_stats_entry_plain(masks, n_bits, a_tile), False)
    int_out, rel_out = _outputs((1 << n_bits) // a_tile, d, masks.device)
    if d == 0:
        return int_out, rel_out, False
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    _raise_on(getattr(_lib(), launcher)(
        masks.data_ptr(), int_out.data_ptr(), rel_out.data_ptr(),
        rows, d, n_bits, a_tile, *args, stream,
    ), launcher)
    return int_out, rel_out, True


def behav_stats_entry(masks: torch.Tensor, n_bits: int, a_tile: int,
                      configs: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: per-A-tile BEHAV partials from the (D, R) config masks alone, at
    ``configs`` (4 or 1) configs a thread of its walk, by default the count
    :func:`entry_configs` picks for the tensor's card."""
    _check_tiling(n_bits, a_tile)
    if configs is None:
        configs = 4
        if masks.device.type == "cuda":
            configs = entry_configs(masks.shape[0], n_bits, a_tile,
                                    _n_sms(masks.device.index))
    return behav_stats_entry_at(masks, n_bits, a_tile, configs)


def behav_stats_entry_at(masks: torch.Tensor, n_bits: int, a_tile: int,
                         configs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2 at ``configs`` (4 or 1) configs a thread of its walk, for the
    comparison of the two on the card; counts on :func:`behav_stats_entry`."""
    if configs not in (4, 1):
        raise ValueError(f"configs={configs} must be 4 or 1")
    int_out, rel_out, launched = _entry_stats("behav_stats_entry_launch", masks, n_bits,
                                              a_tile, configs)
    behav_stats_entry.launches += launched
    return int_out, rel_out


def behav_stats_entry_first(masks: torch.Tensor, n_bits: int,
                            a_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's first design (planes synthesized into shared memory by every
    block) on K2's inputs."""
    int_out, rel_out, launched = _entry_stats("behav_stats_entry_first_launch", masks,
                                              n_bits, a_tile)
    behav_stats_entry_first.launches += launched
    return int_out, rel_out


behav_stats_entry.launches = 0
behav_stats_entry_first.launches = 0
