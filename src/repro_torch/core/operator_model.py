"""LUT-level behavioral model of FPGA-style signed multipliers (AppAxO operator model).

The operator model follows AxOMaP / AppAxO: an approximate operator is an ordered
binary tuple ``O_i(l_0 .. l_{L-1})`` where ``l_k = 1`` keeps LUT ``k`` of the accurate
implementation and ``l_k = 0`` removes it.  Removing a LUT zeroes its sum output AND
truncates the carry out of the associated carry-chain cell (paper Fig. 3 semantics).

Architecture (row-paired partial products, matching the published removable-LUT
counts: signed 4x4 -> L=10, signed 8x8 -> L=36):

  * ``R = N/2`` rows.  Row ``r`` covers multiplier bits ``a_{2r}, a_{2r+1}``.
  * Row value ``V_r = coeff_r * B`` with ``coeff_r = a_{2r} + 2*a_{2r+1}`` for
    ``r < R-1`` and ``coeff_r = a_{2r} - 2*a_{2r+1}`` for the top (sign) row, so that
    ``sum_r 4^r V_r = A * B`` exactly for two's-complement ``A``.
  * Each row is computed as a ``W = N+2`` bit carry-chain addition of the two partial
    products ``T1 = a_{2r} ? B : 0`` and ``T2 = a_{2r+1} ? (+/-B << 1) : 0`` using one
    LUT + carry cell per column (propagate/generate + MUXCY semantics).
  * Columns ``0 .. N`` of every row (``N+1`` per row) are REMOVABLE; the top column
    ``W-1`` (sign handling) and the row-merge adder tree are always accurate.
    ``L = R * (N+1)``:  4x4 -> 2*5 = 10,  8x8 -> 4*9 = 36.

Removal of column ``j`` in a row forces ``sum_j = 0`` and ``carry_{j+1} = 0``.

Everything is vectorized through a precomputed "row table" over
``(top?, a0, a1, B, row_mask)`` so that characterizing thousands of configs over all
``2^{2N}`` input pairs is a handful of numpy gathers.

Beyond the paper's 8x8 signed multiplier (the AxOSyn generalization), the model
is parameterized over operator kind via ``OperatorSpec.op``:

  * ``op="mul"`` -- the row-paired signed multiplier above (any even N).
  * ``op="add"`` -- a signed N-bit carry-chain adder: a single row of width
    ``W = N+1`` adding ``A + B`` with columns ``0..N-1`` removable (the top
    sign column is always accurate), so ``L = N``.

The config -> product mapping is also exposed as a *device function*
(:func:`entry_product` / the ``xp``-generic ``_entry_product``): given the per-row
masks it synthesizes any ``(a, b)`` entry of the product table directly from the
carry-chain model, with no precomputed table.  This is what lets kernels
reconstruct their on-chip tile from the ``(D, L)`` config bits instead of gathering
from a device-memory ``(D, 2^N, 2^N)`` table -- the only viable route at 12/16
bits, where that table cannot be materialized at all.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = [
    "OperatorSpec",
    "spec_for",
    "RowTables",
    "row_tables",
    "config_to_masks",
    "masks_to_config",
    "accurate_config",
    "product_tables",
    "exact_product_table",
    "exact_table",
    "entry_product",
    "entry_row_values",
    "error_tables",
    "simulate_product",
]

OPERATOR_KINDS = ("mul", "add")


@dataclass(frozen=True)
class OperatorSpec:
    """Static description of one approximate-operator family.

    ``signed=True`` (the paper's case) interprets operand codes as two's
    complement and gives the multiplier a Booth-style negated top row;
    ``signed=False`` keeps the same carry-chain/removable-LUT structure but
    reads codes as plain unsigned integers -- no sign row, no wrap -- so the
    accurate config computes the exact unsigned product/sum.
    """

    n_bits: int                       # operand width N
    op: str = "mul"                   # operator kind: "mul" | "add"
    signed: bool = True               # two's-complement (True) or unsigned codes
    rows: int = field(init=False)     # partial-product rows (R = N/2 mul, 1 add)
    width: int = field(init=False)    # per-row adder width (N+2 mul, N+1 add)
    cols_removable: int = field(init=False)  # removable columns per row
    n_luts: int = field(init=False)   # total removable LUTs L

    def __post_init__(self) -> None:
        if self.op not in OPERATOR_KINDS:
            raise ValueError(f"op must be one of {OPERATOR_KINDS}, got {self.op!r}")
        if self.op == "mul":
            if self.n_bits % 2 != 0 or self.n_bits < 2:
                raise ValueError(
                    f"n_bits must be even and >= 2 for op='mul', got {self.n_bits}"
                )
            object.__setattr__(self, "rows", self.n_bits // 2)
            object.__setattr__(self, "width", self.n_bits + 2)
            object.__setattr__(self, "cols_removable", self.n_bits + 1)
        else:  # add: one carry chain of width N+1, sign column accurate
            if self.n_bits < 2:
                raise ValueError(f"n_bits must be >= 2, got {self.n_bits}")
            object.__setattr__(self, "rows", 1)
            object.__setattr__(self, "width", self.n_bits + 1)
            object.__setattr__(self, "cols_removable", self.n_bits)
        object.__setattr__(self, "n_luts", self.rows * self.cols_removable)

    @property
    def n_inputs(self) -> int:
        """Number of distinct values of one operand."""
        return 1 << self.n_bits

    @property
    def operand_values(self) -> np.ndarray:
        """All operand values in code order 0 .. 2^N-1 (two's complement when
        signed, identity when unsigned)."""
        u = np.arange(self.n_inputs, dtype=np.int64)
        if not self.signed:
            return u
        return np.where(u >= self.n_inputs // 2, u - self.n_inputs, u)

    @property
    def n_row_masks(self) -> int:
        return 1 << self.cols_removable

    @property
    def tag(self) -> str:
        """Short stable family name, e.g. ``mul8`` / ``add6u`` (library keys)."""
        return f"{self.op}{self.n_bits}{'' if self.signed else 'u'}"


@functools.lru_cache(maxsize=None)
def spec_for(n_bits: int, op: str = "mul", signed: bool = True) -> OperatorSpec:
    return OperatorSpec(n_bits, op, signed)


# ---------------------------------------------------------------------------
# Row tables
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RowTables:
    """Precomputed per-row behavior, indexed ``[top, a0, a1, b_idx, mask]``.

    value:   signed row output (int32) after carry-truncated addition.
    sum_p1:  P(sum bit j == 1) per column, indexed ``[top, mask, j]`` under uniform
             (a0, a1, B) -- used by the switching-activity power model.
    out_p1:  P(output bit j == 1) of the (two's complement, width-16) row value,
             indexed ``[top, mask, j]`` -- drives the merge-adder activity model.
    """

    spec: OperatorSpec
    value: np.ndarray      # (2, 2, 2, 2^N, 2^(N+1)) int32
    sum_p1: np.ndarray     # (2, 2^(N+1), W) float64
    out_p1: np.ndarray     # (2, 2^(N+1), 16) float64


def _row_values(spec: OperatorSpec) -> np.ndarray:
    """Exhaustive carry-chain evaluation of one row for every mask.

    Returns int32 array of shape (2[top], 2[a0], 2[a1], 2^N[b], 2^(N+1)[mask]).
    """
    n, w = spec.n_bits, spec.width
    n_b = spec.n_inputs
    n_mask = spec.n_row_masks

    b = spec.operand_values.astype(np.int64)  # (n_b,) signed values

    top = np.arange(2).reshape(2, 1, 1, 1, 1)
    a0 = np.arange(2).reshape(1, 2, 1, 1, 1)
    a1 = np.arange(2).reshape(1, 1, 2, 1, 1)
    bv = b.reshape(1, 1, 1, n_b, 1)
    mask = np.arange(n_mask, dtype=np.int64).reshape(1, 1, 1, 1, n_mask)

    modw = (1 << w) - 1
    t1 = np.where(a0 == 1, bv & modw, 0)
    bx = np.where(top == 1, -bv, bv)
    t2 = np.where(a1 == 1, (bx << 1) & modw, 0)

    s = np.zeros(np.broadcast_shapes(t1.shape, t2.shape, mask.shape), dtype=np.int64)
    c = np.zeros_like(s)
    for j in range(w):
        t1j = (t1 >> j) & 1
        t2j = (t2 >> j) & 1
        p = t1j ^ t2j
        g = t1j & t2j
        sj = p ^ c
        c_next = np.where(p == 1, c, g)
        if j < spec.cols_removable:
            kept = (mask >> j) & 1
            sj = sj * kept
            c_next = c_next * kept
        s = s | (sj << j)
        c = c_next

    # Interpret W-bit two's complement.
    sign = 1 << (w - 1)
    val = np.where(s & sign != 0, s - (1 << w), s)
    return val.astype(np.int32)


@functools.lru_cache(maxsize=None)
def row_tables(n_bits: int) -> RowTables:
    spec = spec_for(n_bits)
    value = _row_values(spec)  # (2,2,2,n_b,n_mask)
    w = spec.width
    n_mask = spec.n_row_masks

    # --- per-column sum-bit statistics (for the power model) ------------------
    # Reconstruct W-bit unsigned pattern of the row output.
    u = value.astype(np.int64) & ((1 << w) - 1)
    sum_p1 = np.empty((2, n_mask, w), dtype=np.float64)
    out_p1 = np.empty((2, n_mask, 16), dtype=np.float64)
    u16 = value.astype(np.int64) & 0xFFFF
    for t in range(2):
        # average over a0, a1, b -> (n_mask,)
        for j in range(w):
            bits = (u[t] >> j) & 1
            sum_p1[t, :, j] = bits.mean(axis=(0, 1, 2))
        for j in range(16):
            bits = (u16[t] >> j) & 1
            out_p1[t, :, j] = bits.mean(axis=(0, 1, 2))

    return RowTables(spec=spec, value=value, sum_p1=sum_p1, out_p1=out_p1)


# ---------------------------------------------------------------------------
# Config <-> per-row masks
# ---------------------------------------------------------------------------


def config_to_masks(spec: OperatorSpec, configs: np.ndarray) -> np.ndarray:
    """(..., L) {0,1} array -> (..., R) integer per-row masks."""
    configs = np.asarray(configs)
    if configs.shape[-1] != spec.n_luts:
        raise ValueError(f"config length {configs.shape[-1]} != L={spec.n_luts}")
    cpr = spec.cols_removable
    out = np.zeros(configs.shape[:-1] + (spec.rows,), dtype=np.int64)
    for r in range(spec.rows):
        for j in range(cpr):
            out[..., r] |= configs[..., r * cpr + j].astype(np.int64) << j
    return out


def masks_to_config(spec: OperatorSpec, masks: np.ndarray) -> np.ndarray:
    """(..., R) int masks -> (..., L) {0,1} uint8 config."""
    masks = np.asarray(masks, dtype=np.int64)
    cpr = spec.cols_removable
    out = np.zeros(masks.shape[:-1] + (spec.n_luts,), dtype=np.uint8)
    for r in range(spec.rows):
        for j in range(cpr):
            out[..., r * cpr + j] = (masks[..., r] >> j) & 1
    return out


def accurate_config(spec: OperatorSpec) -> np.ndarray:
    return np.ones(spec.n_luts, dtype=np.uint8)


# ---------------------------------------------------------------------------
# Table-free entry synthesis (config -> product as a device function)
# ---------------------------------------------------------------------------
#
# ``xp`` is the array module (numpy or torch): the same code is the numpy
# oracle (int64, exact at any width) and the device function (int32 --
# exact for every intermediate as long as the *row values* fit, i.e. any
# supported width; the combined product additionally fits int32 for mul up to
# N=14 and add at any width; 16-bit multiplies must stream the per-row values
# and combine them host-side in int64, see ``entry_row_values``).


def _chain_eval(t1, t2, mask, w: int, cpr: int, xp, dtype, signed_out: bool = True):
    """Carry-truncated ``W``-bit add of ``t1 + t2`` under a per-column keep mask.

    ``t1``/``t2`` are W-bit unsigned patterns, ``mask`` the per-row integer
    keep-mask (bit ``j`` keeps column ``j``; columns ``>= cpr`` are always
    kept).  Broadcasts over any common shape; returns the W-bit value, read
    as two's complement when ``signed_out`` (the default) and as a plain
    unsigned pattern otherwise (unsigned operator families).
    """
    if xp is torch:
        # torch int32 ``>>`` is arithmetic, like numpy's, so the bit loop and
        # the sign fix-up below read the same on both branches
        t1, t2, mask = torch.broadcast_tensors(
            t1.to(dtype), t2.to(dtype), mask.to(dtype)
        )
        s = torch.zeros_like(t1)
        c = torch.zeros_like(t1)
    else:
        t1 = t1.astype(dtype)
        t2 = t2.astype(dtype)
        mask = mask.astype(dtype)
        shape = np.broadcast_shapes(np.shape(t1), np.shape(t2), np.shape(mask))
        s = xp.zeros(shape, dtype)
        c = xp.zeros(shape, dtype)
    for j in range(w):
        t1j = (t1 >> j) & 1
        t2j = (t2 >> j) & 1
        p = t1j ^ t2j
        g = t1j & t2j
        sj = p ^ c
        c_next = xp.where(p == 1, c, g)
        if j < cpr:
            kept = (mask >> j) & 1
            sj = sj * kept
            c_next = c_next * kept
        s = s | (sj << j)
        c = c_next
    if not signed_out:
        return s
    sign = 1 << (w - 1)
    return xp.where((s & sign) != 0, s - (1 << w), s)


def _entry_row_values(spec: OperatorSpec, masks, a_codes, b_codes, xp, dtype):
    """Per-row signed values of the approximate op at ``(a, b)``, pre-shift.

    ``masks[..., r]`` must broadcast against ``a_codes``/``b_codes`` (two's
    complement input codes).  Returns a list of ``spec.rows`` arrays; the full
    product is ``sum_r vals[r] << 2r`` (mul) / ``vals[0]`` (add).  Row values
    fit int32 at every supported width, which is what makes this the streaming
    payload for 16-bit multipliers.
    """
    n, w, cpr = spec.n_bits, spec.width, spec.cols_removable
    half = spec.n_inputs // 2
    modw = (1 << w) - 1
    if xp is torch:
        a, b = a_codes.to(dtype), b_codes.to(dtype)
    else:
        a = a_codes.astype(dtype)
        b = b_codes.astype(dtype)
    if spec.signed:
        a_s = xp.where(a >= half, a - 2 * half, a)
        b_s = xp.where(b >= half, b - 2 * half, b)
    else:  # unsigned codes ARE the values; chain outputs read unsigned too
        a_s, b_s = a, b
    if spec.op == "add":
        return [
            _chain_eval(a_s & modw, b_s & modw, masks[..., 0], w, cpr, xp,
                        dtype, signed_out=spec.signed)
        ]
    vals = []
    for r in range(spec.rows):
        top = spec.signed and r == spec.rows - 1
        a0 = (a >> (2 * r)) & 1
        a1 = (a >> (2 * r + 1)) & 1
        t1 = xp.where(a0 == 1, b_s & modw, 0)
        bx = -b_s if top else b_s
        t2 = xp.where(a1 == 1, (bx << 1) & modw, 0)
        vals.append(_chain_eval(t1, t2, masks[..., r], w, cpr, xp, dtype,
                                signed_out=spec.signed))
    return vals


def _entry_product(spec: OperatorSpec, masks, a_codes, b_codes, xp, dtype):
    """Full approximate product/sum from per-row masks (``xp``-generic)."""
    vals = _entry_row_values(spec, masks, a_codes, b_codes, xp, dtype)
    total = vals[0]
    for r in range(1, spec.rows):
        total = total + (vals[r] << (2 * r))
    return total


def entry_product(spec: OperatorSpec, masks, a_codes, b_codes) -> np.ndarray:
    """Numpy oracle of the table-free entry function (int64, exact any width).

    ``masks``: (..., R) per-row masks; ``a_codes``/``b_codes``: two's-complement
    input codes broadcasting against ``masks[..., r]``.
    """
    return _entry_product(
        spec,
        np.asarray(masks, dtype=np.int64),
        np.asarray(a_codes, dtype=np.int64),
        np.asarray(b_codes, dtype=np.int64),
        np,
        np.int64,
    )


def entry_row_values(spec: OperatorSpec, masks, a_codes, b_codes) -> np.ndarray:
    """Numpy twin of the streamed per-row payload: (..., R) int64 row values."""
    vals = _entry_row_values(
        spec,
        np.asarray(masks, dtype=np.int64),
        np.asarray(a_codes, dtype=np.int64),
        np.asarray(b_codes, dtype=np.int64),
        np,
        np.int64,
    )
    return np.stack(np.broadcast_arrays(*vals), axis=-1)


def _synth_small(spec: OperatorSpec, masks, xp, dtype):
    """Per-row small tables synthesized from masks: list of (..., 4, B) arrays.

    ``small[r][..., p, b]`` is row ``r``'s value for multiplier-bit pair
    ``p = 2*a0 + a1`` and operand code ``b`` -- the same ``(4, B)`` layout the
    table-build path gathers out of ``RowTables``, but computed from the
    ``(..., R)`` masks by ``R * 4`` carry-chain evaluations over the B axis
    (``R*4*B*W`` lane-ops total, vs materializing/gathering a
    ``(2, 4, B, 2^(N+1))`` HBM table).  mul only.
    """
    if spec.op != "mul" or not spec.signed:
        raise ValueError(
            f"_synth_small covers the signed multiplier only, got {spec.tag}"
        )
    w, cpr = spec.width, spec.cols_removable
    n_in = spec.n_inputs
    modw = (1 << w) - 1
    if xp is torch:
        b_s = torch.arange(n_in, dtype=dtype, device=masks.device)
    else:
        b_s = xp.arange(n_in, dtype=dtype)
    b_s = xp.where(b_s >= n_in // 2, b_s - n_in, b_s)
    smalls = []
    for r in range(spec.rows):
        top = r == spec.rows - 1
        bx = -b_s if top else b_s
        mask_r = masks[..., r][..., None]  # broadcast over the B axis
        planes = []
        for p in range(4):
            a0, a1 = (p >> 1) & 1, p & 1
            t1 = (b_s & modw) if a0 else xp.zeros_like(b_s)
            t2 = ((bx << 1) & modw) if a1 else xp.zeros_like(b_s)
            planes.append(_chain_eval(t1, t2, mask_r, w, cpr, xp, dtype))
        if xp is torch:
            smalls.append(torch.stack(planes, dim=-2))  # (..., 4, B)
        else:
            smalls.append(xp.stack(planes, axis=-2))

    return smalls


# ---------------------------------------------------------------------------
# Product / error tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def exact_product_table(n_bits: int) -> np.ndarray:
    """(2^N, 2^N) int32 exact signed products, indexed by two's-complement codes."""
    spec = spec_for(n_bits)
    v = spec.operand_values
    return np.multiply.outer(v, v).astype(np.int32)


@functools.lru_cache(maxsize=None)
def exact_table(spec: OperatorSpec) -> np.ndarray:
    """(2^N, 2^N) int64 exact results of ``spec.op``, two's-complement indexed."""
    v = spec.operand_values
    if spec.op == "add":
        return np.add.outer(v, v).astype(np.int64)
    return np.multiply.outer(v, v).astype(np.int64)


def product_tables(spec: OperatorSpec, configs: np.ndarray) -> np.ndarray:
    """Approximate product tables for a batch of configs.

    Args:
      configs: (D, L) {0,1} array.
    Returns:
      (D, 2^N, 2^N) int32; axis 1 indexes operand A's two's-complement code,
      axis 2 operand B's.
    """
    configs = np.atleast_2d(np.asarray(configs))
    if spec.op == "add" or not spec.signed:
        # adders and unsigned families synthesize entries directly (the
        # precomputed RowTables are the signed multiplier's fast path)
        masks = config_to_masks(spec, configs)            # (D, R)
        codes = np.arange(spec.n_inputs, dtype=np.int64)
        return entry_product(
            spec, masks[:, None, None, :], codes[:, None], codes[None, :]
        ).astype(np.int32)
    tabs = row_tables(spec.n_bits)
    masks = config_to_masks(spec, configs)  # (D, R)
    n_in = spec.n_inputs

    a_codes = np.arange(n_in, dtype=np.int64)

    d = configs.shape[0]
    out = np.zeros((d, n_in, n_in), dtype=np.int32)
    for r in range(spec.rows):
        top = 1 if r == spec.rows - 1 else 0
        # (a0, a1) takes only 4 values: gather the small (4, B, D) slab first,
        # then expand over the A axis -- ~65x fewer large-table gathers.
        # reshape(4, ...) flattens (a0, a1) with a0 major -> index = 2*a0 + a1.
        pair_idx = ((((a_codes >> (2 * r)) & 1) << 1) | ((a_codes >> (2 * r + 1)) & 1))
        tab = tabs.value[top].reshape(4, n_in, spec.n_row_masks)  # (4, B, M)
        small = tab[:, :, masks[:, r]]                            # (4, B, D)
        small = np.ascontiguousarray(small.transpose(2, 0, 1))    # (D, 4, B)
        out += small[:, pair_idx, :] << (2 * r)                   # (D, A, B)
    return out


def error_tables(spec: OperatorSpec, configs: np.ndarray) -> np.ndarray:
    """approx - exact, (D, 2^N, 2^N) int32."""
    return (
        product_tables(spec, configs).astype(np.int64)
        - exact_table(spec)[None]
    ).astype(np.int32)


# ---------------------------------------------------------------------------
# Direct (slow) single-pair simulation -- independent oracle used by tests.
# ---------------------------------------------------------------------------


def simulate_product(spec: OperatorSpec, a: int, b: int, config: np.ndarray) -> int:
    """Bit-level simulation of one op, independent of the table machinery."""
    config = np.asarray(config).astype(np.int64)
    n, w = spec.n_bits, spec.width
    if spec.signed:
        half = 1 << (n - 1)
        if not (-half <= a < half and -half <= b < half):
            raise ValueError("operand out of range")
    else:
        if not (0 <= a < (1 << n) and 0 <= b < (1 << n)):
            raise ValueError("operand out of range")
    cpr = spec.cols_removable
    modw = (1 << w) - 1
    if spec.op == "add":
        s = 0
        c = 0
        t1, t2 = a & modw, b & modw
        for j in range(w):
            t1j = (t1 >> j) & 1
            t2j = (t2 >> j) & 1
            p = t1j ^ t2j
            g = t1j & t2j
            sj = p ^ c
            c_next = c if p else g
            if j < cpr and config[j] == 0:
                sj = 0
                c_next = 0
            s |= sj << j
            c = c_next
        if spec.signed and s & (1 << (w - 1)):
            s -= 1 << w
        return int(s)
    total = 0
    for r in range(spec.rows):
        top = spec.signed and r == spec.rows - 1
        a0 = (a >> (2 * r)) & 1
        a1 = (a >> (2 * r + 1)) & 1
        t1 = (b & modw) if a0 else 0
        bx = -b if top else b
        t2 = ((bx << 1) & modw) if a1 else 0
        s = 0
        c = 0
        for j in range(w):
            t1j = (t1 >> j) & 1
            t2j = (t2 >> j) & 1
            p = t1j ^ t2j
            g = t1j & t2j
            sj = p ^ c
            c_next = c if p else g
            if j < cpr and config[r * cpr + j] == 0:
                sj = 0
                c_next = 0
            s |= sj << j
            c = c_next
        if spec.signed and s & (1 << (w - 1)):
            s -= 1 << w
        total += s << (2 * r)
    return int(total)
