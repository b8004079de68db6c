"""Table-GEMV kernels K4 (table) and K5 (entry), each beside its plain version.

``table_gemv`` replaces ``repro/kernels/app_kernels.py::table_gemv_pallas``
and ``entry_gemv`` replaces ``entry_gemv_pallas``; the CUDA source is
``csrc/app_kernels.cu``, whose header says what bounds them on the H100 and
how the design answers it.  Both compute

    out[d, m, n] = sum_k P_d(a[m, k], b[k, n])      (D, M, N) int32

for config-shared operand codes ``a`` (M, K) and ``b`` (K, N), where
``P_d`` is config ``d``'s approximate product: a lookup in its flattened
``(A*B,)`` product table (K4) or the sum of its per-row planes synthesized
from its ``(R,)`` masks (K5).  Codes are read modulo ``2^n_bits`` (the
table-index space ``apps.base.quantize_int8`` produces).  Every table maps
codes ``(0, 0)`` to 0, so zero-code padding of K adds nothing; the kernels
take any K and need no padding.  int32 sums are exact because ``|P| < 2^16``
at up to 8 bits and K is at most ``2^14`` (checked).

On a CPU tensor each wrapper returns its plain version: the reference's
chunked flattened gathers ``fastapp._matmul_take_shared`` (K4) and
``_matmul_entry_shared`` over ``operator_model._synth_small`` planes (K5),
written in torch.  On a CUDA tensor it launches the kernel or raises; it
never falls back.  ``launches`` on each wrapper counts kernel launches.

K4 has two routes, which :func:`plan` picks by shape alone: ``"staged"``
holds one config's table in shared memory (two passes of 128 rows at 8 bits)
and computes all its outputs from it, for shapes with at least
``STAGED_MIN_REUSE`` lookups per table entry that fit its shared memory;
``"gather"``, the first design, gathers the table through the caches, for
the rest.  A call may name a route, and the gather route's tiles (the
tiles the registry's ``fastapp.table`` spec tunes); a shape the route cannot
take raises.  A plan is made once per shape and cached; the wrapper's first
launch of a plan that the current telemetry sees counts
``jit.retrace.app_kernels.plan`` (``plan`` itself records nothing: the
registry probes it for every candidate).
``table_gemv.route_launches`` counts launches by route.  The staged route
runs two grids a call: a packing of the codes as uint8 (and of which table
halves they use), then the GEMV.  Its CUDA launcher computes its
shared-memory layout itself and refuses a shape that does not fit;
:func:`plan` mirrors the layout's size only to choose the route.

K5 runs the staged structure over one config's *nibble planes*, built in
shared memory from its masks: plane q folds rows 2q and 2q + 1 for the 16
values of a's nibble q, so a product is two lookups at 8 bits.  Where D is
below the card's SM count its launcher splits a config's 32-row slabs over
blocks (:func:`entry_splits`), each building its own planes.  K5's first
design, a block per (config, 32-row tile) over the (R, 4, B) planes, stays
callable as :func:`entry_gemv_first` for the comparison on the card, with a
counter of its own.  ``tests/test_torch_kernel_design.py`` emulates K4's
staged route and K5's nibble planes.

K5 also takes 12-bit codes, which K4 and K5's 8-bit design do not (a
12-bit config's nibble planes are 768 KiB): ``entry_gemv`` hands them
to :func:`entry_gemv_wide`, whose block builds the planes per product slot
(the 3 x 16 values of each b-code of a K-chunk) and reuses them across its
rows; it has its own counter.  Its sums are int32 modulo 2^32, as the
reference's; its plain version is ``entry_gemv_plain`` at that width.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..core.operator_model import _synth_small, spec_for
from ..obs.telemetry import current, note_trace
from . import build

__all__ = [
    "Plan",
    "plan",
    "table_gemv",
    "table_gemv_plain",
    "entry_gemv",
    "entry_gemv_first",
    "entry_gemv_plain",
    "entry_gemv_wide",
    "entry_splits",
    "entry_wide_splits",
    "planes_gemv_plain",
]

MAX_BITS = 8          # K4 and K5's 8-bit design: (R, 4, B) planes or tables; |P| < 2^16
ENTRY_MAX_BITS = 12   # K5 at 12 bits (entry_gemv_wide): sums modulo 2^32
MAX_K = 1 << 14       # up to 8 bits, int32 sums of |P| < 2^16 stay exact
M_TILE = 32           # gather route and K5's first design: output rows per block
SMEM_BUDGET = 64 * 1024  # their bytes of shared memory per block (3 blocks per SM)
PLAIN_D_CHUNK = 8     # configs per gather of the plain versions (registry default)
# lookups per config / table entries at which K4 stages: on an H100 the two
# routes cross at 0.5-0.7 in both the convolutions' and the head's shapes
# (chip_smoke.py's boundary sweep, PERF.md section 6)
STAGED_MIN_REUSE = 0.6
# K4's staged layout, as csrc/app_kernels.cu's staged_layout() computes it
# (mirrored for routing only): 16 warps, a warp a (32-row slab, column) item
# a round; K padded to 16-code chunks; a pass holds 128 table rows
STAGED_WARPS = 16
STAGED_SLAB = 32
STAGED_CHUNK = 16
STAGED_PASS_ROWS = 128
MAX_SMEM = 227 * 1024    # dynamic shared memory one block may use


def _pair(a: torch.Tensor, r: int) -> torch.Tensor:
    """Row ``r``'s bit-pair index ``2 * bit_2r(a) + bit_2r+1(a)`` of codes ``a``."""
    return 2 * ((a >> (2 * r)) & 1) + ((a >> (2 * r + 1)) & 1)


def _flat_index(a: torch.Tensor, bt: torch.Tensor, nb: int) -> torch.Tensor:
    """Codes ``a`` (..., M, K) and ``bt`` (N, K) -> (..., M*N*K) flat indices
    ``a * B + b`` in the reference's ``(M, N, K)`` order."""
    return (a[..., :, None, :] * nb + bt).flatten(-3)


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``src`` (Dc, L) at config-shared (X,) or per-config (Dc, X) indices."""
    return src[:, idx] if idx.dim() == 1 else torch.gather(src, 1, idx)


def table_gemv_plain(tables_flat: torch.Tensor, a_codes: torch.Tensor,
                     b_codes: torch.Tensor, d_chunk: int = PLAIN_D_CHUNK) -> torch.Tensor:
    """Plain torch version of K4: (D, A*B) i32 tables, (M, K), (K, N) -> (D, M, N) i32.

    One flattened index ``a * B + b`` per (m, n, k), gathered ``d_chunk``
    configs at a time and reduced over K.  ``a_codes`` may also be per-config
    ``(D, M, K)`` codes; their indices are built per chunk.
    """
    d, ab = tables_flat.shape
    nb = _side(ab)
    m, k = a_codes.shape[-2:]
    n = b_codes.shape[1]
    a = a_codes.long() & (nb - 1)
    bt = (b_codes.long() & (nb - 1)).T
    shared = a.dim() == 2
    idx = _flat_index(a, bt, nb) if shared else None
    out = torch.empty((d, m, n), dtype=torch.int32, device=tables_flat.device)
    for lo in range(0, d, d_chunk):
        tc = tables_flat[lo:lo + d_chunk]
        ic = idx if shared else _flat_index(a[lo:lo + d_chunk], bt, nb)
        out[lo:lo + d_chunk] = _take(tc, ic).reshape(len(tc), m, n, k).sum(-1, dtype=torch.int32)
    return out


def planes_gemv_plain(small: torch.Tensor, a_codes: torch.Tensor,
                      b_codes: torch.Tensor, d_chunk: int = PLAIN_D_CHUNK,
                      acc_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """The table-free gather: (R, D, 4, B) i32 planes, (M, K), (K, N) -> (D, M, N) i32.

    ``out[d, m, n] = sum_r (sum_k small[r, d, pair_r(a[m, k]), b[k, n]]) << 2r``,
    one flattened per-row gather into the ``(4*B,)`` planes per (m, n, k),
    summed modulo 2^32 as the reference sums (``acc_dtype=torch.int64`` gives
    the exact sums instead).  ``a_codes`` may also be per-config ``(D, M, K)``
    codes.
    """
    rows, d, _, nb = small.shape
    m, k = a_codes.shape[-2:]
    n = b_codes.shape[1]
    a = a_codes.long() & (nb - 1)
    bt = (b_codes.long() & (nb - 1)).T
    sf = small.permute(1, 0, 2, 3).reshape(d, rows, 4 * nb)
    shared = a.dim() == 2
    idxs = [_flat_index(_pair(a, r), bt, nb) for r in range(rows)] if shared else None
    out = torch.empty((d, m, n), dtype=acc_dtype, device=small.device)
    for lo in range(0, d, d_chunk):
        sc = sf[lo:lo + d_chunk]
        acc = None
        for r in range(rows):
            ic = idxs[r] if shared else _flat_index(_pair(a[lo:lo + d_chunk], r), bt, nb)
            term = _take(sc[:, r], ic).reshape(len(sc), m, n, k).sum(-1, dtype=acc_dtype)
            term = term << (2 * r)
            acc = term if acc is None else acc + term
        out[lo:lo + d_chunk] = acc
    return out


def entry_gemv_plain(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
                     n_bits: int, d_chunk: int = PLAIN_D_CHUNK,
                     acc_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Plain torch version of K5: (D, R) i32 masks -> K4's output.

    Planes come from the carry-chain synthesis (``operator_model._synth_small``).
    """
    small = torch.stack(_synth_small(spec_for(n_bits), masks, torch, torch.int32))
    return planes_gemv_plain(small, a_codes, b_codes, d_chunk, acc_dtype)


def _side(ab: int) -> int:
    """B for a flattened (A*B,) table with A = B a power of two."""
    n_bits = (ab.bit_length() - 1) // 2
    if ab != 1 << (2 * n_bits):
        raise ValueError(f"table length {ab} is not 4^n_bits")
    return 1 << n_bits


def _check(t: torch.Tensor, name: str, ndim: int, device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_codes(a: torch.Tensor, b: torch.Tensor, device, n_bits: int,
                 max_bits: int = MAX_BITS) -> None:
    _check(a, "a_codes", 2, device)
    _check(b, "b_codes", 2, device)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"a_codes (M, K) {tuple(a.shape)} and b_codes (K, N) "
                         f"{tuple(b.shape)} disagree on K")
    if a.shape[1] > MAX_K:
        raise ValueError(f"K={a.shape[1]} > {MAX_K}: int32 sums could overflow")
    if not 1 <= n_bits <= max_bits:
        raise ValueError(f"this table-GEMV kernel takes 1..{max_bits}-bit codes, got {n_bits}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _tiles(m: int, k: int, n: int, plane_ints: int) -> tuple[int, int]:
    """(m_tile, k_tile) that fit the block's shared-memory budget."""
    m_tile = min(M_TILE, m)
    avail = SMEM_BUDGET // 4 - plane_ints
    k_tile = min(k, (avail - m_tile) // (m_tile + n))
    if k_tile < 1:
        raise ValueError(f"N={n} is too wide to stage one K row in shared memory")
    return m_tile, k_tile


class Plan(NamedTuple):
    route: str          # "staged" or "gather"
    m_tile: int         # gather: output rows a block owns
    k_tile: int         # gather: K rows a shared-memory chunk
    smem: int           # dynamic shared memory a block, bytes


def _staged_smem(m: int, k: int, n: int, n_bits: int) -> int:
    """Shared memory of the staged route's block: a table pass (a half at 8
    bits), the config's sums (N, M_pad + 1) int32, B's codes (N, K_pad) and
    two A tiles of whole 32-row slabs (rows an odd multiple of 16 bytes)."""
    k_pad = -(-k // STAGED_CHUNK) * STAGED_CHUNK
    a_stride = k_pad + STAGED_CHUNK * (1 - (k_pad // STAGED_CHUNK) % 2)
    slab_cap = min(-(-m // STAGED_SLAB), (STAGED_WARPS - 1) // n + 2)
    pass_ints = min(1 << n_bits, STAGED_PASS_ROWS) << n_bits
    m_pad = -(-m // STAGED_SLAB) * STAGED_SLAB
    return (pass_ints * 4 + -(-n * (m_pad + 1) // 4) * 16 + -(-n * k_pad // 16) * 16
            + 2 * slab_cap * STAGED_SLAB * a_stride)


@functools.lru_cache(maxsize=1024)
def plan(m: int, k: int, n: int, n_bits: int, route: str | None = None,
         m_tile: int | None = None, k_tile: int | None = None) -> Plan:
    """K4's launch for (M, K) x (K, N) codes of ``n_bits`` bits.

    Without ``route``: ``"staged"`` where a config makes at least
    ``STAGED_MIN_REUSE`` lookups per table entry (M*N*K / 4^n_bits), its
    codes have 2..8 bits and its table pass, B's codes and two A tiles fit
    ``MAX_SMEM``; else ``"gather"``.  A named route that cannot take the
    shape raises.  ``m_tile`` and ``k_tile`` name the gather route's tiles
    (default: the largest that fit ``SMEM_BUDGET``); tiles that do not fit
    ``MAX_SMEM`` raise.
    """
    if route not in (None, "staged", "gather"):
        raise ValueError(f"unknown K4 route {route!r}")
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"K4 takes codes of at most {MAX_BITS} bits, got {n_bits}")
    smem = _staged_smem(m, k, n, n_bits)
    fits = 2 <= n_bits <= MAX_BITS and smem <= MAX_SMEM
    if route == "staged" and not fits:
        raise ValueError(f"K4's staged route cannot take M={m} K={k} N={n} at {n_bits} bits "
                         f"({smem} bytes of shared memory)")
    if route == "staged" or (route is None and fits
                             and m * n * k >= STAGED_MIN_REUSE * (1 << 2 * n_bits)):
        if m_tile or k_tile:
            raise ValueError("K4's staged route takes no gather tiles")
        return Plan("staged", 0, 0, smem)
    if m_tile is None and k_tile is None:
        m_tile, k_tile = _tiles(m, k, n, 0)
    elif not (m_tile and k_tile and m_tile >= 1 and k_tile >= 1):
        raise ValueError(f"K4's gather route needs both tiles, got m_tile={m_tile}, "
                         f"k_tile={k_tile}")
    smem = (m_tile * (k_tile + 1) + k_tile * n) * 4
    if smem > MAX_SMEM:
        raise ValueError(f"K4's gather tiles m_tile={m_tile}, k_tile={k_tile} need {smem} "
                         f"bytes of shared memory at N={n}, over {MAX_SMEM}")
    return Plan("gather", m_tile, k_tile, smem)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("app_kernels")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.table_gemv_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.table_gemv_launch.restype = ctypes.c_int
    ll = ctypes.c_longlong
    lib.table_gemv_staged_scratch.argtypes = [i, i, i, i]
    lib.table_gemv_staged_scratch.restype = ll
    lib.table_gemv_staged_launch.argtypes = [p, p, p, p, ll, p, i, i, i, i, i, p]
    lib.table_gemv_staged_launch.restype = ctypes.c_int
    lib.entry_gemv_first_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, p]
    lib.entry_gemv_first_launch.restype = ctypes.c_int
    lib.entry_gemv_scratch.argtypes = [i, i, i]
    lib.entry_gemv_scratch.restype = ll
    lib.entry_gemv_splits.argtypes = [i, i, i, i, i]
    lib.entry_gemv_splits.restype = ctypes.c_int
    lib.entry_gemv_launch.argtypes = [p, p, p, p, ll, p, i, i, i, i, i, p]
    lib.entry_gemv_launch.restype = ctypes.c_int
    lib.entry_gemv_wide_splits.argtypes = [i, i, i, i, i]
    lib.entry_gemv_wide_splits.restype = ctypes.c_int
    lib.entry_gemv_wide_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.entry_gemv_wide_launch.restype = ctypes.c_int
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _note_launch(m: int, k: int, n: int, pl: Plan) -> None:
    """``jit.retrace.app_kernels.plan``, once a (shape, plan) on the current telemetry."""
    if current().first(("app_kernels", m, k, n, pl)):
        note_trace("app_kernels.plan")


def table_gemv(tables_flat: torch.Tensor, a_codes: torch.Tensor,
               b_codes: torch.Tensor, route: str | None = None,
               m_tile: int | None = None, k_tile: int | None = None) -> torch.Tensor:
    """K4: (D, A*B) i32 flattened product tables, (M, K), (K, N) i32 -> (D, M, N) i32.

    ``route`` names K4's route on the card and ``m_tile``, ``k_tile`` the
    gather route's tiles; by default :func:`plan` picks them.  A route or
    tiles the shape cannot take raise, on the CPU too.
    """
    _check(tables_flat, "tables_flat", 2, tables_flat.device)
    d, ab = tables_flat.shape
    nb = _side(ab)
    n_bits = nb.bit_length() - 1
    _check_codes(a_codes, b_codes, tables_flat.device, n_bits)
    (m, k), n = a_codes.shape, b_codes.shape[1]
    named = (route, m_tile, k_tile) != (None, None, None)
    if tables_flat.device.type == "cpu":
        if named and d * m * n and k:
            _note_launch(m, k, n, plan(m, k, n, n_bits, route, m_tile, k_tile))
        return table_gemv_plain(tables_flat, a_codes, b_codes)
    if d * m * n == 0 or k == 0:
        return torch.zeros((d, m, n), dtype=torch.int32, device=tables_flat.device)
    pl = plan(m, k, n, n_bits, route, m_tile, k_tile)
    _note_launch(m, k, n, pl)
    out = torch.empty((d, m, n), dtype=torch.int32, device=tables_flat.device)
    stream = torch.cuda.current_stream(tables_flat.device).cuda_stream
    if pl.route == "staged":
        # the uint8 codes and the packing blocks' flags, sized by the launcher
        scratch = torch.empty(_lib().table_gemv_staged_scratch(m, k, n, n_bits),
                              dtype=torch.uint8, device=tables_flat.device)
        err = _lib().table_gemv_staged_launch(
            tables_flat.data_ptr(), a_codes.data_ptr(), b_codes.data_ptr(),
            scratch.data_ptr(), scratch.numel(), out.data_ptr(), d, m, k, n, n_bits, stream)
    else:
        err = _lib().table_gemv_launch(
            tables_flat.data_ptr(), a_codes.data_ptr(), b_codes.data_ptr(), out.data_ptr(),
            d, m, k, n, n_bits, pl.m_tile, pl.k_tile, stream)
    _raise_on(err, f"table_gemv ({pl.route} route)")
    table_gemv.launches += 1
    table_gemv.route_launches[pl.route] += 1
    return out


table_gemv.launches = 0
table_gemv.route_launches = {"staged": 0, "gather": 0}


def _entry_args(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
                n_bits: int, max_bits: int = ENTRY_MAX_BITS) -> int:
    """Check K5's operands; its row count R."""
    _check_codes(a_codes, b_codes, masks.device, n_bits, max_bits)
    rows = spec_for(n_bits).rows
    _check(masks, "masks", 2, masks.device)
    if masks.shape[1] != rows:
        raise ValueError(f"masks must have shape (D, {rows}), got {tuple(masks.shape)}")
    return rows


def entry_splits(d: int, m: int, k: int, n: int, n_bits: int) -> int:
    """Blocks a config's 32-row slabs are split over by K5's launcher on the
    current card (more where D is below the SM count), 0 where K5 cannot take
    the shape.  Needs the card."""
    return _lib().entry_gemv_splits(d, m, k, n, n_bits)


def entry_gemv(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
               n_bits: int) -> torch.Tensor:
    """K5: (D, R) i32 config masks, (M, K), (K, N) i32 -> (D, M, N) i32.

    Signed multipliers of at most 12 bits; above 8 bits the call is
    :func:`entry_gemv_wide`'s.  On the card a block synthesizes its config's
    nibble planes and computes its slabs' outputs from them; a shape whose
    layout exceeds the block's shared memory raises.
    """
    _entry_args(masks, a_codes, b_codes, n_bits)
    if n_bits > MAX_BITS:
        return entry_gemv_wide(masks, a_codes, b_codes, n_bits)
    if masks.device.type == "cpu":
        return entry_gemv_plain(masks, a_codes, b_codes, n_bits)
    d = masks.shape[0]
    (m, k), n = a_codes.shape, b_codes.shape[1]
    if d * m * n == 0 or k == 0:
        return torch.zeros((d, m, n), dtype=torch.int32, device=masks.device)
    out = torch.empty((d, m, n), dtype=torch.int32, device=masks.device)
    # the uint8 codes, sized by the launcher
    scratch = torch.empty(_lib().entry_gemv_scratch(m, k, n), dtype=torch.uint8,
                          device=masks.device)
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    err = _lib().entry_gemv_launch(
        masks.data_ptr(), a_codes.data_ptr(), b_codes.data_ptr(), scratch.data_ptr(),
        scratch.numel(), out.data_ptr(), d, m, k, n, n_bits, stream)
    if err and entry_splits(d, m, k, n, n_bits) == 0:   # refused before any launch
        raise ValueError(f"K5 cannot take M={m} K={k} N={n} at {n_bits} bits: its layout "
                         f"exceeds {MAX_SMEM} bytes of shared memory")
    _raise_on(err, "entry_gemv")
    entry_gemv.launches += 1
    return out


def entry_wide_splits(d: int, m: int, k: int, n: int, n_bits: int) -> int:
    """Blocks a config's 32-row slabs are split over by K5's 12-bit launcher
    on the current card, 0 where it cannot take the shape.  Needs the card."""
    return _lib().entry_gemv_wide_splits(d, m, k, n, n_bits)


def entry_gemv_wide(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
                    n_bits: int) -> torch.Tensor:
    """K5 at 12 bits: (D, 6) i32 masks, (M, K), (K, N) i32 -> (D, M, N) i32
    sums modulo 2^32.  On the card a block builds the nibble-plane values of
    each K-chunk's b-codes (3 x 16 a code) in shared memory and sums its rows'
    products from them; a shape whose slots for one K-code exceed the block's
    shared memory raises."""
    _entry_args(masks, a_codes, b_codes, n_bits)
    if n_bits != ENTRY_MAX_BITS:
        raise ValueError(f"entry_gemv_wide takes 12-bit codes, got {n_bits}")
    if masks.device.type == "cpu":
        return entry_gemv_plain(masks, a_codes, b_codes, n_bits)
    d = masks.shape[0]
    (m, k), n = a_codes.shape, b_codes.shape[1]
    if d * m * n == 0 or k == 0:
        return torch.zeros((d, m, n), dtype=torch.int32, device=masks.device)
    if entry_wide_splits(d, m, k, n, n_bits) == 0:
        raise ValueError(f"K5 cannot take M={m} K={k} N={n} at {n_bits} bits: one K-code's "
                         f"slots exceed {MAX_SMEM} bytes of shared memory")
    out = torch.empty((d, m, n), dtype=torch.int32, device=masks.device)
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    _raise_on(_lib().entry_gemv_wide_launch(
        masks.data_ptr(), a_codes.data_ptr(), b_codes.data_ptr(), out.data_ptr(),
        d, m, k, n, n_bits, stream), "entry_gemv_wide")
    entry_gemv_wide.launches += 1
    return out


def entry_gemv_first(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
                     n_bits: int) -> torch.Tensor:
    """K5's first design (a block per (config, 32-row tile), products from
    the (R, 4, B) planes in shared memory) on K5's inputs, up to 8 bits."""
    rows = _entry_args(masks, a_codes, b_codes, n_bits, MAX_BITS)
    if masks.device.type == "cpu":
        return entry_gemv_plain(masks, a_codes, b_codes, n_bits)
    d = masks.shape[0]
    (m, k), n = a_codes.shape, b_codes.shape[1]
    if d * m * n == 0 or k == 0:
        return torch.zeros((d, m, n), dtype=torch.int32, device=masks.device)
    out = torch.empty((d, m, n), dtype=torch.int32, device=masks.device)
    m_tile, k_tile = _tiles(m, k, n, rows * 4 << n_bits)
    stream = torch.cuda.current_stream(masks.device).cuda_stream
    _raise_on(_lib().entry_gemv_first_launch(
        masks.data_ptr(), a_codes.data_ptr(), b_codes.data_ptr(), out.data_ptr(),
        rows, d, m, k, n, n_bits, m_tile, k_tile, stream,
    ), "entry_gemv_first")
    entry_gemv_first.launches += 1
    return out


entry_gemv.launches = 0
entry_gemv_wide.launches = 0
entry_gemv_first.launches = 0
