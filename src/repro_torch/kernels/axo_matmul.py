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
``axo_matmul.launches`` counts kernel launches, ``axo_matmul.route_launches``
each route's.  Any M, K and N work: the
kernel masks its ragged tiles itself.

The kernel has five routes, which :func:`plan` picks by M: up to ``GEMV_M``
rows (decode, kimi-k2's expert buffers of 16 and 8 rows) the small-M route at
the ranks the source builds it for (``SMALL_RANKS``; not granite's wide head at
4 rows, where the GEMV ran faster): tensor cores with the
activation rows on the MMA's 8-wide side, 8 or 16 rows a block, so that each
weight code is expanded once for all of them, from a table held as planes of
four entries in 8 copies (three loads a code at rank 8); the f32 GEMV on the
FMA pipe it replaced is reachable as ``route="gemv"`` and keeps the other
ranks; up to ``SKINNY_M`` rows (the MoE
prefill's expert buffers) the skinny tensor-core route, which computes
out^T = B^T A^T so that the weight's columns fill the MMA's 16-row side and
the activation rows its 8-wide side, in blocks of 24 or 80 rows; from
``WGMMA_M`` rows (the prefills' 512 rows, the encoder's and the
cross-attention's thousands of frames and image tokens) the wgmma route:
128 x 128 tiles whose code tiles arrive by TMA and are expanded through the
tables once a block, into TF32 hi and lo planes that warpgroup MMAs read (K
and N whole multiples of 16, the TMA's row strides, and the tables within
its block's shared memory); otherwise (M = 81..511, or off that alignment)
128 x 128 ``mma.sync`` tiles.
The tensor-core routes feed TF32 with each factor split into hi + lo (three
passes; the integer values take one), each 32-code step summed from zero in
the tensor core, so ``tests/test_torch_kernel_design.py`` emulates them with
one model of their rounding (the wgmma route takes a step's table rows one
after another over its 32 codes, the others 8 codes at a time; the small-M
route sums each 8-code group from zero, its warps along K in warp order).  The tile and k-step
constants below plan the launch; the kernel's source owns its layout and
refuses a plan that does not fit it.

:func:`plan` picks the route and the K splits; a caller may name either
(``route=``, ``splits=``; the splits are the tile the registry's
``axo_matmul.kernel`` spec tunes).  A plan is made
once per shape and cached, and records nothing: the registry probes it for
every candidate.  The wrapper's first launch of a plan that the current
telemetry sees counts ``jit.retrace.axo_matmul.plan`` and records the
launch's pad-to-tile waste (``axo_matmul.pad_waste``) there; later launches
cost one set lookup.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..obs.telemetry import current, note_trace, record_pad_waste
from . import build

__all__ = ["axo_matmul", "axo_matmul_plain", "plan", "Plan", "route_for"]

MAX_SMEM = 227 * 1024      # dynamic shared memory one block may use
H100_SMS = 132             # plan()'s default; a launch passes its card's count
GEMV_M = 16                # M at or below this takes the small-M route or the GEMV
# GEMV route (csrc/axo_matmul.cu): 4 warps x 16 columns a lane, MT rows a block
GEMV_COLS = 512
GEMV_KSTEP = 32            # K rows expanded per shared-memory chunk
GEMV_PER_SM = 2            # blocks an SM runs at once
GEMV_MAX_SPLITS = 64
GEMV_BLOCK_COST = 1        # a block's fixed work (tables, sums), in k-steps
# tensor-core route: 128 x 128 tile, 8 warps, 32 codes of K a step
MMA_TILE = 128
MMA_KSTEP = 32
MMA_PER_SM = 1
MMA_MAX_SPLITS = 16
MMA_BLOCK_COST = 4
MMA_STAGE = 2 * (MMA_TILE * 48 + MMA_KSTEP * 144)   # double-buffered code tiles, bytes
# skinny tensor-core route (16 < M <= SKINNY_M): rows a block -> weight columns a
# block (the instances csrc/axo_matmul.cu builds) and blocks an SM holds at once
# (its registers); 4 warps, 32 codes a step.  24 and 80 are the expert buffers
# the port serves (deepseek-v3's and jamba's); M = 25..79 pads to 80
SKINNY_M = 80
SKINNY_TILES = {24: 128, 80: 64}
SKINNY_PER_SM = {24: 4, 80: 3}
SKINNY_MAX_SPLITS = 32
SKINNY_BLOCK_COST = 2
# wgmma route (M >= WGMMA_M, K and N multiples of 16, the tables within a
# block's shared memory): 128 x 128 tiles, two consumer warpgroups and an
# expansion warpgroup, one block an SM; shared memory: 1024 bytes of
# alignment, three stages of four 16 KB planes, one stage of 8 KB code tiles,
# 64 bytes of barriers, then the two tables (rank <= 11 at 8-bit codes).  On
# the H100 it beats the 128 x 128 mma.sync tiles at the 512-row prefills
# (granite's four projections, deepseek-67b's gate/up) and at whisper's 6,000
# and the VLM's 6,400 rows (chip_smoke.py times both routes; PERF.md section
# 6); M = 81..511 keeps route 1 (not measured there)
WGMMA_M = 512
WGMMA_TILE = 128
WGMMA_ALIGN = 16           # the TMA's row strides, bytes: K and N multiples of it
WGMMA_FIXED_SMEM = (1024 + 3 * 4 * WGMMA_TILE * MMA_KSTEP * 4 + 2 * WGMMA_TILE * MMA_KSTEP
                    + 64)
WGMMA_BLOCK_COST = 4
# small-M route (M <= GEMV_M at the ranks the source builds it for): tensor
# cores with the activation rows on the MMA's 8-wide side, 8 or 16 rows a
# block (one expansion of each weight code for all of them); 8 warps, each 4
# weight tiles of 16 columns, cols // 64 of them along N and the rest along
# K; the weight table as planes of 4 entries in 8 copies (csrc/axo_matmul.cu).
# A block owns 512 columns where N >= SMALL_WIDE_N, else 256: on the H100 the
# narrower block won by 6-40% at N = 512 to 2048; from N = 7168 to 50280 the
# two came within 6% of each other either way (chip_smoke.py's
# k6_block_widths; PERF.md section 6).  Two 8-row blocks fit an SM (ptxas: at
# most 128 registers a thread), one 16-row block (its registers and shared
# memory).  At M <= 4 and N >= SMALL_GEMV_N the GEMV keeps the shape: the
# small route won at N = 8192, 32768 and 40960, the GEMV at N = 49155
# (granite's head); chip_smoke.py times both at N = 40960 and 49152, on
# either side of the cutoff
SMALL_COLS = (256, 512)    # the block widths the source builds
SMALL_WIDE_N = 4096
SMALL_GEMV_N = 45056
SMALL_RANKS = (8,)         # the ranks the source builds the route for (its loops unroll)
SMALL_PLANE = 256 * 8 * 16   # a table plane: 256 code slots x 8 copies of 4 entries, bytes
SMALL_PER_SM = {8: 2, 16: 1}
SMALL_MAX_SPLITS = 64
SMALL_BLOCK_COST = 1
ROUTES = ("gemv", "mma", "skinny", "wgmma", "small")   # in the launcher's route numbers
_REFUSED = -2              # the launcher's answer to codes the TMA cannot map


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


class Plan(NamedTuple):
    route: str          # "small" or "gemv" (M <= GEMV_M), "skinny" (M <= SKINNY_M), "mma", "wgmma"
    rows: int           # output rows a block owns: 8 or 16; MT = 1, 2, 4 or 8; 24 or 80; 128
    splits: int         # blocks along K, summed in split order in the kernel
    k_split: int        # codes of K per split: whole k-steps of the route
    smem: int           # dynamic shared memory per block, bytes
    tiles: int          # output tiles, one split-K counter each
    cols: int           # output columns a block owns


def _split_k(tiles: int, k: int, kstep: int, wave: int, max_splits: int,
             block_cost: int) -> tuple[int, int]:
    """(splits, codes per split) that minimise waves x (k-steps a block takes
    + its fixed cost): enough blocks to fill the SMs, few enough that the
    last wave is not mostly idle; whole k-steps per split."""
    best = None
    for want in range(1, max(1, min(max_splits, -(-k // kstep))) + 1):
        k_split = -(-(-(-k // want)) // kstep) * kstep
        splits = -(-k // k_split)
        cost = -(-tiles * splits // wave) * (k_split // kstep + block_cost)
        if best is None or cost < best[0]:
            best = (cost, splits, k_split)
    return best[1], best[2]


def _k_split(k: int, kstep: int, splits: int, max_splits: int) -> tuple[int, int]:
    """(splits, codes per split) for a named split count: whole k-steps a
    split, so K may take fewer splits than named."""
    if not 1 <= splits <= max_splits:
        raise ValueError(f"K6 takes 1..{max_splits} K splits on this route, got {splits}")
    k_split = -(-(-(-k // splits)) // kstep) * kstep
    return -(-k // k_split), k_split


def _wgmma_fits(n: int, k: int, rank: int, n_codes: int) -> bool:
    """Whether the wgmma route takes K and N (the TMA's row strides) and its
    block holds the two tables."""
    return (not (n % WGMMA_ALIGN or k % WGMMA_ALIGN)
            and WGMMA_FIXED_SMEM + 2 * (rank + 1) * n_codes * 4 <= MAX_SMEM)


def _small_smem(rows: int, cols: int, rank: int, n_codes: int) -> int:
    """A small-M block's shared memory: the weight table's planes of 4 entries
    in 8 copies (the last plane 1, 2 or 3 entries wide), whose region then
    holds the K warps' partial sums, and two 32-code steps' (4, 1+R, rows / 8,
    32) float2 activation fragments."""
    r1 = rank + 1
    planes = SMALL_PLANE * (r1 // 4) + (SMALL_PLANE if r1 % 4 == 3 else
                                        SMALL_PLANE // 2 if r1 % 4 else 0)
    wn = cols // 64
    reduce = (8 // wn - 1) * wn * 32 * 4 * (rows // 8) * 4 * 4
    return max(planes, reduce) + 2 * 4 * r1 * (rows // 8) * 32 * 8


def _small_plan(m: int, n: int, k: int, rank: int, n_codes: int, n_sms: int,
                splits: int | None, cols: int | None = None) -> Plan:
    """The small-M route's launch: 8 rows a block up to M = 8, else 16, and
    ``cols`` columns (one of ``SMALL_COLS``; default 512 where N >=
    ``SMALL_WIDE_N``, else 256)."""
    rows = 8 if m <= 8 else 16
    cols = (SMALL_COLS[1] if n >= SMALL_WIDE_N else SMALL_COLS[0]) if cols is None else cols
    tiles = -(-n // cols)
    smem = _small_smem(rows, cols, rank, n_codes)
    if splits is None:
        splits, k_split = _split_k(tiles, k, MMA_KSTEP, SMALL_PER_SM[rows] * n_sms,
                                   SMALL_MAX_SPLITS, SMALL_BLOCK_COST)
    else:
        splits, k_split = _k_split(k, MMA_KSTEP, splits, SMALL_MAX_SPLITS)
    return Plan("small", rows, splits, k_split, smem, tiles, cols)


def route_for(m: int, n: int, k: int, rank: int, n_codes: int) -> str:
    """The route :func:`plan` takes at M rows (the rank, and N at M <= 4,
    decide whether the small-M route takes M <= ``GEMV_M``; N, K, the rank
    and the codes whether the wgmma route's TMA maps the codes and its block
    holds the tables): a pure function of the shape."""
    if m <= GEMV_M:
        return "small" if rank in SMALL_RANKS and (m > 4 or n < SMALL_GEMV_N) else "gemv"
    if m <= SKINNY_M:
        return "skinny"
    return "wgmma" if m >= WGMMA_M and _wgmma_fits(n, k, rank, n_codes) else "mma"


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, rank: int, n_codes: int, n_sms: int = H100_SMS,
         splits: int | None = None, route: str | None = None) -> Plan:
    """The launch of K6 for an (m, k) x (k, n) product at this rank.

    M <= ``GEMV_M`` takes the small-M route at the ranks it is built for
    (not at M <= 4 with N >= ``SMALL_GEMV_N``): a block owns 8 rows up to
    M = 8, else 16, and 512 columns where N >= ``SMALL_WIDE_N``, else 256;
    named, the GEMV route (and the plan's at the other shapes): 512
    columns and MT rows (the least power of two >= M, at most 8; M = 9..16
    takes two row groups of 8).  M <= ``SKINNY_M`` takes the skinny tensor-core route: a block
    owns 24 rows and 128 columns up to M = 24, else 80 rows and 64 columns
    (so no padded row at M = 24 and 80).  Larger M takes 128 x 128 tiles,
    on the wgmma route from ``WGMMA_M`` rows where K and N are multiples of
    16.  K splits into whole k-steps (32 codes on every route) until the
    blocks fill the ``n_sms`` SMs (two GEMV blocks or one tensor-core block
    per SM at a time) in as few waves as the work allows, counting a block's
    fixed cost; ``splits`` names the split count instead (whole k-steps a
    split, so K may take fewer).  ``route`` names the route instead of
    :func:`route_for`'s (the skinny route only up to ``SKINNY_M`` rows, the
    GEMV and the small-M route only up to ``GEMV_M``, the small-M route only
    at ``SMALL_RANKS``, the wgmma route only where K and N are multiples of
    16; the mma route takes any M).  Cached: a decode step asks for the same
    few shapes hundreds of times.
    """
    r1 = rank + 1
    route = route_for(m, n, k, rank, n_codes) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"K6 has the routes {ROUTES}, got {route!r}")
    if route == "small" and rank not in SMALL_RANKS:
        raise ValueError(f"K6's small route is built for the ranks {SMALL_RANKS}, got {rank}")
    if (route in ("gemv", "small") and m > GEMV_M) or (route == "skinny" and m > SKINNY_M):
        raise ValueError(f"K6's {route} route takes at most "
                         f"{SKINNY_M if route == 'skinny' else GEMV_M} rows, got {m}")
    if route == "wgmma" and (n % WGMMA_ALIGN or k % WGMMA_ALIGN):
        raise ValueError(f"K6's wgmma route takes K and N in multiples of {WGMMA_ALIGN}, got "
                         f"K {k}, N {n}")
    if route == "small":
        return _small_plan(m, n, k, rank, n_codes, n_sms, splits)
    if route == "gemv":
        rows = 1 << max(0, (min(m, 8) - 1).bit_length())
        tiles = -(-n // GEMV_COLS) * -(-m // rows)
        if splits is None:
            splits, k_split = _split_k(tiles, k, GEMV_KSTEP, GEMV_PER_SM * n_sms,
                                       GEMV_MAX_SPLITS, GEMV_BLOCK_COST)
        else:
            splits, k_split = _k_split(k, GEMV_KSTEP, splits, GEMV_MAX_SPLITS)
        # the weight-side table, whose space then holds the warps' partial
        # sums; the activation-side table; the chunk's activation values
        smem = (max(r1 * n_codes, 4 * min(rows, 4) * GEMV_COLS) + r1 * n_codes
                + GEMV_KSTEP * r1 * rows) * 4
        return Plan("gemv", rows, splits, k_split, smem, tiles, GEMV_COLS)
    if route == "skinny":
        rows = min(r for r in SKINNY_TILES if r >= m)
        cols = SKINNY_TILES[rows]
        tiles = -(-n // cols) * -(-m // rows)
        if splits is None:
            splits, k_split = _split_k(tiles, k, MMA_KSTEP, SKINNY_PER_SM[rows] * n_sms,
                                       SKINNY_MAX_SPLITS, SKINNY_BLOCK_COST)
        else:
            splits, k_split = _k_split(k, MMA_KSTEP, splits, SKINNY_MAX_SPLITS)
        # the two tables; double-buffered (rows, 48) and (32, cols + 16) code tiles
        smem = 2 * r1 * n_codes * 4 + 2 * (rows * 48 + MMA_KSTEP * (cols + 16))
        return Plan("skinny", rows, splits, k_split, smem, tiles, cols)
    if route == "wgmma":
        tiles = -(-n // WGMMA_TILE) * -(-m // WGMMA_TILE)
        if splits is None:
            splits, k_split = _split_k(tiles, k, MMA_KSTEP, MMA_PER_SM * n_sms, MMA_MAX_SPLITS,
                                       WGMMA_BLOCK_COST)
        else:
            splits, k_split = _k_split(k, MMA_KSTEP, splits, MMA_MAX_SPLITS)
        smem = WGMMA_FIXED_SMEM + 2 * r1 * n_codes * 4
        return Plan("wgmma", WGMMA_TILE, splits, k_split, smem, tiles, WGMMA_TILE)
    tiles = -(-n // MMA_TILE) * -(-m // MMA_TILE)
    if splits is None:
        splits, k_split = _split_k(tiles, k, MMA_KSTEP, MMA_PER_SM * n_sms, MMA_MAX_SPLITS,
                                   MMA_BLOCK_COST)
    else:
        splits, k_split = _k_split(k, MMA_KSTEP, splits, MMA_MAX_SPLITS)
    smem = 2 * r1 * n_codes * 4 + MMA_STAGE
    return Plan("mma", MMA_TILE, splits, k_split, smem, tiles, MMA_TILE)


def _note_launch(m: int, n: int, k: int, pl: Plan) -> None:
    """Once a (shape, plan) on the current telemetry: ``jit.retrace.axo_matmul.plan``
    and the pad waste of the launch's (M, N, K) space on its route's tiles."""
    if not current().first(("axo_matmul", m, n, k, pl)):
        return
    note_trace("axo_matmul.plan")
    kstep = GEMV_KSTEP if pl.route == "gemv" else MMA_KSTEP
    record_pad_waste("axo_matmul", (m, n, k), (-(-m // pl.rows) * pl.rows,
                                               -(-n // pl.cols) * pl.cols,
                                               -(-k // kstep) * kstep))


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("axo_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.axo_matmul_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                      i, i, ctypes.c_longlong, p]
    lib.axo_matmul_launch.restype = ctypes.c_int
    return lib


_LAYOUT_MISMATCH = -1      # the launcher's answer to a plan that does not fit the kernel
_COUNTERS: dict = {}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _counters(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    """Zeroed int32 split-K counters, one per output tile, for launches on one
    stream; every launch leaves the ones it used at zero again.  A stream's
    launches run in order, so they can share them; another stream's would
    not, and get their own."""
    have = _COUNTERS.get((device, stream))
    if have is None or have.numel() < tiles:
        have = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = have
    return have


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
               g_table: torch.Tensor, signed_vals: torch.Tensor,
               splits: int | None = None, route: str | None = None) -> torch.Tensor:
    """K6: uint8 codes (M, K), (K, N); f32 tables (2^n, R), (2^n, R), (2^n,) -> (M, N) f32.

    ``splits`` names the K splits and ``route`` the route (default:
    :func:`plan`'s); a count or route the shape does not take raises.  On a
    CPU tensor the launch is planned (at an H100's SM count) as on the card,
    then the plain version runs.
    """
    _check(a_codes, b_codes, f_table, g_table, signed_vals)
    (m, k), n = a_codes.shape, b_codes.shape[1]
    rank, n_codes = f_table.shape[1], signed_vals.shape[0]
    if a_codes.device.type == "cpu":
        if m * n and k:
            _note_launch(m, n, k, plan(m, n, k, rank, n_codes, H100_SMS, splits, route))
        return axo_matmul_plain(a_codes, b_codes, f_table, g_table, signed_vals)
    if m * n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=a_codes.device)
    pl = plan(m, n, k, rank, n_codes, _sm_count(a_codes.device), splits, route)
    _note_launch(m, n, k, pl)
    return _launch(a_codes, b_codes, f_table, g_table, signed_vals, pl)


def _launch(a_codes, b_codes, f_table, g_table, signed_vals, pl: Plan) -> torch.Tensor:
    """Launch K6 on CUDA tensors that passed :func:`_check`, as ``pl`` says."""
    (m, k), n = a_codes.shape, b_codes.shape[1]
    if pl.smem > MAX_SMEM:
        raise ValueError(f"rank {f_table.shape[1]} needs {pl.smem} bytes of shared memory "
                         f"per block, over {MAX_SMEM}")
    dev = a_codes.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = (torch.empty((pl.splits, m, n), dtype=torch.float32, device=dev)
          if pl.splits > 1 else out)
    # the current stream's raw handle (what current_stream().cuda_stream reads,
    # without making a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    counters = _counters(dev, stream, pl.tiles)
    err = _lib().axo_matmul_launch(
        a_codes.data_ptr(), b_codes.data_ptr(), signed_vals.data_ptr(), f_table.data_ptr(),
        g_table.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
        counters.numel(), m, n, k, f_table.shape[1], signed_vals.shape[0],
        ROUTES.index(pl.route), pl.rows, pl.cols, pl.splits, pl.k_split, pl.smem, stream,
    )
    if err == _LAYOUT_MISMATCH:
        raise RuntimeError(f"{pl} does not fit the layout of csrc/axo_matmul.cu")
    if err == _REFUSED:
        raise ValueError(f"K6's wgmma route needs codes whose base and rows start on "
                         f"16-byte boundaries: a at {a_codes.data_ptr():#x}, b at "
                         f"{b_codes.data_ptr():#x}, K {k}, N {n}")
    if err != 0:
        raise RuntimeError(f"axo_matmul launch failed: cudaError {err}")
    axo_matmul.launches += 1
    axo_matmul.route_launches[pl.route] += 1
    return out


axo_matmul.launches = 0
axo_matmul.route_launches = dict.fromkeys(ROUTES, 0)
