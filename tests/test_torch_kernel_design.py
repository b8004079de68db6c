"""The numerical designs of K6 (AxO matmul), K7 (flash attention) and K8
(SSD scan), and the index designs of K4 (table GEMV) and K1 (BEHAV
statistics), emulated in plain torch on the CPU.

K6's tensor-core route feeds TF32 operands (10 stored mantissa bits) to
``mma.sync``: the integer operand values in one pass, each factor split as
hi + lo in three (hi.hi + hi.lo + lo.hi), each 32-code step summed from zero
in the tensor core and added to the running sum in IEEE f32.  K7's bf16
kernel carries its softmax weights p as a bf16 hi + lo pair through P.V.
K6's skinny route (16 < M <= 80) sums the same terms in the same order,
split by split; K7's wgmma route rounds its weights once to bf16 over
128-key tiles, as the TPU kernel does.  These tests hold the emulated
designs to the contracts the card checks: K6 within 1e-5 relative norm of an
f64 result (and of the reference's ``ref_axo_matmul_lowrank``), K7 within
2^-7 of the output's largest magnitude of the plain version (and of the
reference's ``ref_flash_attention``), and they check that both kernels'
``plan`` routes and splits as the kernels expect.  K8's bf16 route feeds every f32 operand
(M, w x, the state) to bf16 ``mma.sync`` as three bf16 terms; its emulation
is held against the reference's sequential scan and its Pallas kernel (those
tests need JAX and skip without it).  K4's staged route (two table halves
in a swizzled shared-memory image, each pass doing only its own lookups) and
K1's register walk are held, exactly, to the plain versions, the reference's
numpy ``table_matmul`` and its XLA twin ``_partials_xla``; ``plan`` is
checked to route K4 by shape.  No card is needed.
"""

import math

import numpy as np
import pytest
import torch

from repro.apps.base import table_matmul as ref_table_matmul
from repro.core.operator_model import product_tables as ref_product_tables
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch.axo import AxOOperator
from repro_torch.core import fastchar
from repro_torch.core.operator_model import config_to_masks, spec_for
from repro_torch.kernels import app_kernels as k4
from repro_torch.kernels import axo_matmul as k6
from repro_torch.kernels import char_kernels as k1
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ssd_scan as k8
from repro_torch.launch.serve import demo_operator

REL = 1e-5


# -- K6's tensor-core arithmetic, emulated ---------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 stored mantissa bits), nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000     # add half of the 13 dropped bits, clear them
    return bits.view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated to TF32: the 13 low mantissa bits cleared, as the tensor
    core reads a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_matmul(a_codes: torch.Tensor, b_codes: torch.Tensor, f_table: torch.Tensor,
                    g_table: torch.Tensor, signed_vals: torch.Tensor, *, passes: int = 3,
                    chain: int | None = None) -> torch.Tensor:
    """The tensor-core route's arithmetic in plain torch (f64 sums): the
    values in one pass (exact in TF32), the factors in ``passes`` (1: hi.hi;
    3: lo.hi + hi.lo + hi.hi), with hi = x rounded to TF32 and lo = x - hi
    truncated to TF32, as the kernel splits them and the tensor core reads
    them.  With ``chain`` the sum also rounds as the tensor core's
    accumulator is modelled here: each 8-code MMA adds its exact products to
    the accumulator and rounds the result toward zero to f32, and every
    ``chain`` codes of K the accumulator restarts from zero and is added to
    the running f32 sum with IEEE rounding.  Within a chain the terms come in
    the kernel's order (its ``chain`` is its 32-code step): 8 codes at a
    time, the table rows from the last factor down to the values, each
    factor lo.hi, hi.lo, hi.hi."""
    a = a_codes.long()
    b = b_codes.long()
    sv = tf32_trunc(signed_vals.float())
    rows = [[(sv[a].double(), sv[b].double())]]
    for r in range(f_table.shape[1]):
        fa, gb = f_table[:, r].float()[a], g_table[:, r].float()[b]
        fh, gh = tf32_round(fa), tf32_round(gb)
        row = [(fh.double(), gh.double())]
        if passes == 3:
            row = [(tf32_trunc(fa - fh).double(), gh.double()),
                   (fh.double(), tf32_trunc(gb - gh).double())] + row
        rows.append(row)
    if chain is None:
        return sum(x @ y for row in rows for x, y in row).float()
    (m, k), n = a.shape, b.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32)
    for c0 in range(0, k, chain):
        acc = torch.zeros((m, n), dtype=torch.float64)
        for k0 in range(c0, min(k, c0 + chain), 8):
            for row in reversed(rows):
                for x, y in row:
                    acc = _round_toward_zero(acc + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        out = out + acc.float()
    return out


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """f64 -> the f32 value next to it toward zero, kept in f64."""
    f = x.float()
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f).double()


# -- K7's softmax weights, emulated ----------------------------------------

def p_hi_lo(p: torch.Tensor) -> torch.Tensor:
    """The softmax weights as the bf16 kernel feeds them to P.V: bf16(p) + bf16(p - bf16(p))."""
    hi = p.to(torch.bfloat16).float()
    return hi + (p - hi).to(torch.bfloat16).float()


@pytest.fixture(scope="module")
def operators():
    """The serve path's demo operator and a random 36-bit config, whose error
    table (and so its factor part) dominates the product."""
    cfg = np.random.default_rng(36).integers(0, 2, 36).astype(np.uint8)
    return {"demo": demo_operator(8), "random36": AxOOperator.from_config(cfg, rank=8)}


def _tables(op):
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32))
                 for t in (op.f_table, op.g_table, op.signed_vals))


def _codes(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)))


def _f64(a, b, f, g, sv):
    a, b = a.long(), b.long()
    out = sv.double()[a] @ sv.double()[b]
    for r in range(f.shape[1]):
        out += f[:, r].double()[a] @ g[:, r].double()[b]
    return out


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got.double() - want)
                 / torch.linalg.vector_norm(want))


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 3 * 2.0 ** -11), 3.0e38], dtype=torch.float32)
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                         -(1.0 + 2.0 ** -9), 3.0e38], dtype=torch.float32)
    assert torch.equal(got[:5], want[:5])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    err = ((tf32_round(y) - y) / y).abs().max()
    assert float(err) <= 2.0 ** -11


def test_signed_values_are_exact_in_tf32(operators):
    """The value part takes one TF32 pass: every 8-bit code's value survives."""
    codes = torch.arange(-128, 128, dtype=torch.float32)
    assert torch.equal(tf32_round(codes), codes)
    for op in operators.values():
        sv = torch.from_numpy(op.signed_vals.astype(np.float32))
        assert sv.numel() == 256 and torch.equal(tf32_round(sv), sv)


@pytest.mark.parametrize("name", ["demo", "random36"])
def test_three_pass_tf32_holds_the_contract(operators, name):
    """hi/lo split of the factors at M=64, K=2048, N=256: three passes sit far
    under 1e-5; one pass misses it where the factor part dominates."""
    f, g, sv = _tables(operators[name])
    a, b = _codes(64, 2048, 256, 1)
    want = _f64(a, b, f, g, sv)
    three = _rel(tf32_matmul(a, b, f, g, sv, passes=3), want)
    one = _rel(tf32_matmul(a, b, f, g, sv, passes=1), want)
    assert three < REL / 100, three
    assert three < one
    if name == "random36":
        assert one > REL, one


@pytest.mark.parametrize("name", ["demo", "random36"])
def test_tensor_core_sum_restarts_every_step(operators, name):
    """With the accumulator rounding toward zero after every 8-code MMA, the
    kernel's 32-code restarts hold 1e-5; one chain over all of K does not hold
    it for the random config."""
    f, g, sv = _tables(operators[name])
    a, b = _codes(32, 2048, 64, 2)
    want = _f64(a, b, f, g, sv)
    step = _rel(tf32_matmul(a, b, f, g, sv, chain=k6.MMA_KSTEP), want)
    assert step < REL, step
    if name == "random36":
        whole = _rel(tf32_matmul(a, b, f, g, sv, chain=2048), want)
        assert whole > REL > step, (whole, step)


@pytest.mark.parametrize("m, k, n", [(1, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048),
                                     (4, 2048, 49155), (8, 768, 50280), (16, 2048, 2048),
                                     (17, 2048, 2048), (64, 1000, 77), (512, 2048, 8192),
                                     (512, 2048, 512), (5, 40, 3), (6000, 1024, 1024),
                                     (6400, 8192, 1024), (512, 1000, 2048)])
@pytest.mark.parametrize("rank", [8, 16])
def test_plan_routes_by_m_with_whole_steps(m, k, n, rank):
    pl = k6.plan(m, n, k, rank, 256)
    if m <= k6.GEMV_M and rank in k6.SMALL_RANKS and (m > 4 or n < k6.SMALL_GEMV_N):
        # one block of 8 rows (the MMA's n8 side) up to M = 8, else of 16:
        # every weight code expanded once for all M rows; 512 columns on
        # wide weights, else 256
        assert pl.route == "small" and pl.rows == (8 if m <= 8 else 16)
        assert pl.cols == (512 if n >= k6.SMALL_WIDE_N else 256)
        assert pl.tiles == -(-n // pl.cols)
        step = k6.MMA_KSTEP
    elif m <= k6.GEMV_M:
        # ranks the small route is not built for, and the wide head at 4
        # rows, keep the GEMV
        assert pl.route == "gemv" and pl.rows in (1, 2, 4, 8) and pl.rows >= min(m, 8)
        assert pl.rows < 2 * min(m, 8)              # no more than the next power of two
        assert pl.tiles == -(-n // k6.GEMV_COLS) * -(-m // pl.rows)
        step = k6.GEMV_KSTEP
    elif m <= k6.SKINNY_M:
        # the least block of rows that holds M, and its columns
        assert pl.route == "skinny" and pl.rows in k6.SKINNY_TILES and pl.rows >= m
        assert all(r < m for r in k6.SKINNY_TILES if r < pl.rows)
        assert pl.cols == k6.SKINNY_TILES[pl.rows]
        assert pl.tiles == -(-n // pl.cols) * -(-m // pl.rows)
        step = k6.MMA_KSTEP
    else:
        # the wgmma route from WGMMA_M rows where the TMA maps the codes and
        # the tables fit its block, else route 1; both 128 x 128 tiles
        wgmma = m >= k6.WGMMA_M and k % 16 == 0 == n % 16 and rank < 12
        assert pl.route == ("wgmma" if wgmma else "mma")
        assert pl.rows == k6.MMA_TILE == k6.WGMMA_TILE == pl.cols
        assert pl.tiles == -(-n // k6.MMA_TILE) * -(-m // k6.MMA_TILE)
        step = k6.MMA_KSTEP
    assert pl.k_split % step == 0
    assert (pl.splits - 1) * pl.k_split < k <= pl.splits * pl.k_split
    assert pl.smem <= k6.MAX_SMEM
    if pl.route == "gemv":
        assert pl.smem <= k6.MAX_SMEM // 2          # two blocks per SM
        assert pl.splits <= k6.GEMV_MAX_SPLITS
    elif pl.route == "small":
        assert pl.splits <= k6.SMALL_MAX_SPLITS
    else:
        assert pl.splits <= (k6.SKINNY_MAX_SPLITS if pl.route == "skinny"
                             else k6.MMA_MAX_SPLITS)
    per_sm = {"gemv": k6.GEMV_PER_SM, "mma": k6.MMA_PER_SM, "wgmma": k6.MMA_PER_SM,
              "small": k6.SMALL_PER_SM.get(pl.rows)}.get(pl.route)
    per_sm = per_sm or k6.SKINNY_PER_SM[pl.rows]
    assert pl.splits == 1 or pl.tiles < 4 * per_sm * k6.H100_SMS


@pytest.mark.parametrize("m, k, n", [(4, 2048, 8192), (4, 2048, 49155), (512, 2048, 2048)])
def test_plan_splits_less_on_a_card_with_fewer_sms(m, k, n):
    """The wave the splits fill is the card's SM count: half the SMs never
    take more splits, and the plan stays whole k-steps."""
    full, half = k6.plan(m, n, k, 8, 256), k6.plan(m, n, k, 8, 256, n_sms=k6.H100_SMS // 2)
    assert half.splits <= full.splits and half[:2] == full[:2]
    assert half.route == k6.route_for(m, n, k, 8, 256)
    assert half.k_split % k6.MMA_KSTEP == 0


def test_plan_at_the_serve_shapes():
    # granite decode on the small-M route (8-row blocks, two an SM): the
    # gate/up projection's 16 tiles of 512 columns split K 16 ways (one wave
    # of 256 blocks); k/v's 2 tiles of 256 split it 64 ways; the head's
    # 49155 columns keep the GEMV (97 tiles, 8 ways: three full waves)
    assert k6.plan(4, 8192, 2048, 8, 256)[:4] == ("small", 8, 16, 128)
    assert k6.plan(4, 8192, 2048, 8, 256).cols == 512
    assert k6.plan(4, 512, 2048, 8, 256)[:4] == ("small", 8, 64, 32)
    assert k6.plan(4, 49155, 2048, 8, 256)[:4] == ("gemv", 4, 8, 256)
    # mamba2's head: 8 rows, no padding, 99 tiles of 512 split 5 ways
    assert k6.plan(8, 50280, 768, 8, 256)[:3] == ("small", 8, 5)
    # kimi-k2's expert buffers: 16 rows (one block an SM) at the prefill, 8
    # at decode
    assert k6.plan(16, 2048, 7168, 8, 256)[:4] == ("small", 16, 16, 448)
    assert k6.plan(8, 7168, 2048, 8, 256)[:4] == ("small", 8, 16, 128)
    # granite prefill, on the wgmma route: the gate/up tiles fill two waves,
    # no split; q/o's 64 tiles split K in two
    assert k6.plan(512, 8192, 2048, 8, 256)[:3] == ("wgmma", 128, 1)
    assert k6.plan(512, 2048, 2048, 8, 256)[:3] == ("wgmma", 128, 2)
    assert k6.plan(16, 64, 64, 8, 256).route == "small"
    assert k6.plan(17, 64, 64, 8, 256).route == "skinny"
    # the MoE prefill's expert buffers: deepseek-v3's 24 rows (gate/up 16
    # column tiles split K 32 ways: four blocks an SM; down 56 tiles 8 ways)
    # and jamba's 80 (three blocks an SM)
    assert k6.plan(24, 2048, 7168, 8, 256)[:4] == ("skinny", 24, 32, 224)
    assert k6.plan(24, 7168, 2048, 8, 256)[:4] == ("skinny", 24, 8, 256)
    assert k6.plan(80, 14336, 4096, 8, 256)[:3] == ("skinny", 80, 5)
    assert k6.plan(80, 4096, 14336, 8, 256)[:3] == ("skinny", 80, 6)
    assert k6.plan(81, 4096, 14336, 8, 256).route == "mma"


@pytest.mark.parametrize("m, k, n", [(24, 7168, 2048), (24, 2048, 7168), (80, 4096, 14336),
                                     (80, 14336, 4096)])
def test_skinny_plan_at_the_expert_buffers(m, k, n):
    """The skinny route at deepseek-v3's and jamba's prefill expert buffers:
    a block of exactly M rows, whole 32-code steps a split, the splits
    within the route's limit and its blocks within one wave or more (never
    a last wave of a few blocks), shared memory within a block's, and no
    pad waste (M rows, N a whole number of column tiles, K of steps)."""
    from repro_torch.obs import telemetry as tm

    pl = k6.plan(m, n, k, 8, 256)
    assert pl.route == "skinny" and pl.rows == m and n % pl.cols == 0
    assert pl.tiles == n // pl.cols
    assert pl.k_split % k6.MMA_KSTEP == 0 and pl.splits * pl.k_split >= k
    assert 1 <= pl.splits <= k6.SKINNY_MAX_SPLITS
    assert pl.smem <= k6.MAX_SMEM // 2
    blocks = pl.tiles * pl.splits
    assert blocks >= k6.H100_SMS * 0.8 or pl.splits == k6.SKINNY_MAX_SPLITS
    tel = tm.Telemetry("t")
    with tm.use(tel):
        k6._note_launch(m, n, k, pl)
    assert tel.gauges["axo_matmul.pad_waste"] == 0.0
    # route 1 at the same shape pads rows to 128
    tel = tm.Telemetry("t")
    with tm.use(tel):
        k6._note_launch(m, n, k, k6.plan(m, n, k, 8, 256, route="mma"))
    assert tel.gauges["axo_matmul.pad_waste"] == pytest.approx(1 - m / 128)


def test_k6_named_routes():
    """A route named by the caller: the tensor-core route at any M, the
    skinny one up to SKINNY_M rows, the GEMV and the small-M route up to
    GEMV_M (the small one at the ranks it is built for); splits as named."""
    assert k6.plan(24, 2048, 7168, 8, 256, route="mma")[:2] == ("mma", 128)
    assert k6.plan(8, 2048, 7168, 8, 256, route="skinny")[:2] == ("skinny", 24)
    assert k6.plan(24, 2048, 7168, 8, 256, splits=8, route="skinny")[:3] == ("skinny", 24, 8)
    # the GEMV the small-M route replaced stays reachable by name
    assert k6.plan(8, 2048, 7168, 8, 256, route="gemv")[:2] == ("gemv", 8)
    assert k6.plan(4, 2048, 2048, 8, 256, splits=5, route="small")[:3] == ("small", 8, 5)
    for bad in (dict(m=81, route="skinny"), dict(m=17, route="gemv"), dict(m=8, route="x"),
                dict(m=17, route="small")):
        with pytest.raises(ValueError):
            k6.plan(bad["m"], 64, 64, 8, 256, route=bad["route"])
    with pytest.raises(ValueError):
        k6.plan(8, 64, 64, 16, 256, route="small")
    with pytest.raises(ValueError):
        k6.plan(24, 64, 4096, 8, 256, splits=33)


@pytest.mark.parametrize("m, k, n", [(16, 7168, 2048), (16, 2048, 7168), (8, 7168, 2048),
                                     (8, 2048, 7168), (4, 2048, 2048), (4, 2048, 512),
                                     (4, 2048, 8192), (4, 8192, 2048), (8, 768, 50280)])
def test_small_plan_at_the_expert_and_decode_shapes(m, k, n):
    """The small-M route at kimi-k2's expert buffers (M = 16 at the prefill,
    8 at decode), granite-3-2b's four decode projections (M = 4) and
    mamba2's head: a block of the fewest rows the MMA's 8-wide side allows,
    its columns, whole 32-code steps a split, the splits within the route's
    limit, shared memory within a block's and, at 8 rows, within two blocks
    an SM (a block also holds 1 KB of the SM's), and no pad waste beyond the
    8-row side's (none at M = 8 and 16) and a ragged N's."""
    from repro_torch.obs import telemetry as tm

    pl = k6.plan(m, n, k, 8, 256)
    assert (pl.route, pl.rows) == ("small", 8 if m <= 8 else 16)
    assert pl.cols == (512 if n >= k6.SMALL_WIDE_N else 256) and pl.tiles == -(-n // pl.cols)
    assert pl.k_split % k6.MMA_KSTEP == 0
    assert (pl.splits - 1) * pl.k_split < k <= pl.splits * pl.k_split
    assert 1 <= pl.splits <= k6.SMALL_MAX_SPLITS
    assert pl.smem == k6._small_smem(pl.rows, pl.cols, 8, 256) <= k6.MAX_SMEM
    if pl.rows == 8:
        assert 2 * (pl.smem + 1024) <= 228 * 1024
    tel = tm.Telemetry("t")
    with tm.use(tel):
        k6._note_launch(m, n, k, pl)
    assert k % k6.MMA_KSTEP == 0                  # K pads to no step
    padded = pl.rows * pl.tiles * pl.cols * k
    assert tel.gauges["axo_matmul.pad_waste"] == pytest.approx(1 - m * n * k / padded)
    assert m < 8 or n % pl.cols or tel.gauges["axo_matmul.pad_waste"] == 0.0


def test_small_route_leaves_granite_head_to_the_gemv():
    """At 4 rows against granite's 49155-word head the GEMV ran faster on the
    H100 (PERF.md section 6), so the plan keeps it there; named, the small-M
    route still takes the shape, and at 8 rows (mamba2's head) the plan
    takes it."""
    assert k6.route_for(4, 49155, 2048, 8, 256) == "gemv"
    assert k6.route_for(4, k6.SMALL_GEMV_N - 1, 2048, 8, 256) == "small"
    assert k6.route_for(5, 49155, 2048, 8, 256) == "small"
    assert k6.route_for(4, 40960, 2048, 8, 256) == "small"     # it won there too
    assert k6.plan(4, 49155, 2048, 8, 256, route="small")[:3] == ("small", 8, 8)


def test_sass_reads_the_k6_instances_the_launcher_builds():
    """``kernels/sass.py`` names K6's small-M and GEMV instances by their
    mangled template arguments: each is one the launcher in
    ``csrc/axo_matmul.cu`` instantiates, and the small-M ones are the four
    block shapes the plan takes at the ranks the route is built for."""
    import re
    from pathlib import Path

    from repro_torch.kernels import sass

    src = (Path(k6.__file__).parent / "csrc" / "axo_matmul.cu").read_text()
    launchers = {"axo_small_kernel": "launch_small", "axo_gemv_kernel": "launch_gemv"}
    small = set()
    for name in sass.KERNELS["axo_matmul"]:
        kernel, args = re.fullmatch(r"(axo_\w+?_kernel)I((?:Li\d+E)+)E", name).groups()
        vals = [int(v) for v in re.findall(r"Li(\d+)E", args)]
        assert f"&{launchers[kernel]}<{', '.join(map(str, vals))}>" in src
        if kernel == "axo_small_kernel":
            nt, wn, r1 = vals[:3]
            assert r1 - 1 in k6.SMALL_RANKS
            small.add((8 * nt, 64 * wn))
    assert small == {(rows, cols) for rows in k6.SMALL_PER_SM for cols in k6.SMALL_COLS}


@pytest.mark.parametrize("m, rows", [(17, 24), (24, 24), (25, 80), (40, 80), (80, 80)])
def test_skinny_blocks_are_the_served_row_counts(m, rows):
    """The skinny route is built for the two expert buffers the port serves,
    24 rows (deepseek-v3) and 80 (jamba): M up to 24 takes 24-row blocks of
    128 columns, M = 25..80 80-row blocks of 64; M = 81 is route 1's."""
    assert sorted(k6.SKINNY_TILES) == [24, 80]
    pl = k6.plan(m, 4096, 2048, 8, 256)
    assert (pl.route, pl.rows, pl.cols) == ("skinny", rows, k6.SKINNY_TILES[rows])
    assert pl.tiles == 4096 // pl.cols
    assert k6.plan(m + 56 if m > 24 else 81, 4096, 2048, 8, 256)[:2] == ("mma", 128)


def skinny_emulated(a_codes, b_codes, f, g, sv, pl) -> torch.Tensor:
    """The skinny route's sums: each split of ``pl.k_split`` codes its own
    chain of 32-code steps (``tf32_matmul`` with the tensor core's
    rounding, the table rows from the last factor down, each factor lo.hi,
    hi.lo, hi.hi: route 1's order, the MMA's operands swapped), the partials
    then summed in split order in f32, as the last block of a tile sums them."""
    k = a_codes.shape[1]
    parts = [tf32_matmul(a_codes[:, k0:k0 + pl.k_split], b_codes[k0:k0 + pl.k_split], f, g, sv,
                         chain=k6.MMA_KSTEP) for k0 in range(0, k, pl.k_split)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


@pytest.fixture(scope="module")
def jax_k6_ref():
    """The reference's ``ref_axo_matmul_lowrank`` (needs JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import ref_axo_matmul_lowrank

    def run(a, b, f, g, sv):
        out = ref_axo_matmul_lowrank(*(jnp.asarray(t.numpy()) for t in (a, b, f, g, sv)))
        return torch.from_numpy(np.array(out))

    return run


@pytest.mark.parametrize("m, k, n", [(24, 1024, 64), (80, 768, 48), (24, 300, 40)])
@pytest.mark.parametrize("name", ["demo", "random36"])
def test_skinny_route_sums_hold_the_contract(operators, jax_k6_ref, name, m, k, n):
    """At M = 24 and 80 on narrow K and N (the plan's own splits: 32, 24 and
    10 of them), the skinny route's summation order holds 1e-5 relative norm
    against the plain version, the reference's ``ref_axo_matmul_lowrank`` and
    an f64 sum."""
    f, g, sv = _tables(operators[name])
    a, b = _codes(m, k, n, m + k)
    pl = k6.plan(m, n, k, 8, 256)
    assert pl.route == "skinny" and pl.splits > 1
    got = skinny_emulated(a, b, f, g, sv, pl)
    assert _rel(got, _f64(a, b, f, g, sv)) < REL
    plain = k6.axo_matmul(a, b, f, g, sv)
    assert _rel(got, plain.double()) < REL
    assert _rel(got, jax_k6_ref(a, b, f, g, sv).double()) < REL


# -- K6's wgmma route: planes expanded once a block, table row by table row --

def wgmma_step_sums(a_codes, b_codes, f, g, sv) -> torch.Tensor:
    """Every 32-code step of the wgmma route as the tensor core sums it, all
    steps at once: (steps, M, N) f32.  Within a step the table rows run from
    the last factor down to the values, each row over the step's four
    8-code slices, each factor slice lo.hi, hi.lo, hi.hi (the values' one
    pass hi.hi); every 8-code product is added to the accumulator, which
    rounds toward zero to f32 and starts the step at zero.  The operands are
    the K-major planes the expansion warpgroup writes: hi = x rounded to
    TF32, lo = x - hi, which the tensor core truncates to TF32; codes past K
    give 0 on B's side (A's are zero codes, whose values meet those zeros)."""
    step = k6.MMA_KSTEP
    (m, k), n = a_codes.shape, b_codes.shape[1]
    steps = -(-k // step)
    a = torch.zeros((m, steps * step), dtype=torch.long)
    a[:, :k] = a_codes.long()
    b = b_codes.long()
    acc = torch.zeros((steps, m, n), dtype=torch.float64)
    for j in range(f.shape[1], -1, -1):
        ta = sv.float() if j == 0 else f[:, j - 1].float()
        tb = sv.float() if j == 0 else g[:, j - 1].float()
        xa = ta[a]                                                   # (m, steps * 32)
        xb = torch.zeros((steps * step, n))
        xb[:k] = tb[b]
        ah, bh = tf32_round(xa), tf32_round(xb)
        al, bl = tf32_trunc(xa - ah), tf32_trunc(xb - bh)
        passes = [(ah, bh)] if j == 0 else [(al, bh), (ah, bl), (ah, bh)]
        # (steps, m, 32) and (steps, 32, n): each step's slice of K
        passes = [(x.double().reshape(m, steps, step).transpose(0, 1),
                   y.double().reshape(steps, step, n)) for x, y in passes]
        for k0 in range(0, step, 8):
            for x, y in passes:
                acc = _round_toward_zero(acc + x[:, :, k0:k0 + 8] @ y[:, k0:k0 + 8])
    return acc.float()


def wgmma_emulated(a_codes, b_codes, f, g, sv, pl) -> torch.Tensor:
    """The wgmma route's sums: each split of ``pl.k_split`` codes a chain of
    32-code steps (:func:`wgmma_step_sums`) added in IEEE f32 in step order,
    the partials summed in split order, as the last block of a tile sums
    them."""
    sums = wgmma_step_sums(a_codes, b_codes, f, g, sv)
    per_split = pl.k_split // k6.MMA_KSTEP
    out = None
    for s0 in range(0, sums.shape[0], per_split):
        part = sums[s0]
        for s in range(s0 + 1, min(sums.shape[0], s0 + per_split)):
            part = part + sums[s]
        out = part if out is None else out + part
    return out


def plane_offset(row: int, k: int) -> int:
    """Where the expansion warpgroup writes element (row, k) of a 128 x 32
    TF32 plane: csrc/axo_matmul.cu plane_chunk (the 16-byte chunk k // 4 of
    the row's 128-byte line, XOR-ed with row mod 8), then k mod 4 words in."""
    return row * 128 + (((k // 4) ^ (row % 8)) << 4) + 4 * (k % 4)


def wgmma_reads(row: int, kk: int, k8: int) -> int:
    """Where wgmma reads element (row, 8 kk + k8) of a K-major operand under
    the 128-byte swizzle: the descriptor's start address advanced by 32 kk
    bytes, 8-row groups 1,024 bytes apart, rows 128 bytes apart, and the
    hardware's XOR of address bits 4-6 with bits 7-9."""
    linear = row * 128 + 32 * kk + 4 * k8
    return linear ^ (((linear >> 7) & 7) << 4)


def test_wgmma_planes_are_where_wgmma_reads_them():
    """Every (row, k) of a 128 x 32 plane is written to a distinct word, the
    one the K-major 128-byte-swizzled descriptor reads for it; a warp's
    16-byte stores (A: 4 rows x 8 chunks; B: 32 rows, one chunk each) fall
    on 4 wavefronts of 128 bytes, the fewest 512 bytes take."""
    seen = set()
    for row in range(k6.WGMMA_TILE):
        for k in range(k6.MMA_KSTEP):
            off = plane_offset(row, k)
            assert off == wgmma_reads(row, k // 8, k % 8)
            seen.add(off)
    assert seen == set(range(0, k6.WGMMA_TILE * k6.MMA_KSTEP * 4, 4))
    for i in range(8):                         # a warp's lanes p = 0..31, chunk index i
        a_rows = [(p >> 3) + 16 * i for p in range(32)]
        a_banks = [(plane_offset(r, 4 * (p & 7)) // 4) % 32 for p, r in zip(range(32), a_rows)]
        b_banks = [(plane_offset(p, 4 * i) // 4) % 32 for p in range(32)]
        for banks in (a_banks, b_banks):       # each 16-byte store covers 4 banks
            load = [sum(1 for b in banks if b == bank) for bank in range(0, 32, 4)]
            assert max(load) == 4


@pytest.mark.parametrize("m, k, n", [(6000, 1024, 1024), (6400, 8192, 1024)])
def test_wgmma_plan_at_thousands_of_rows(m, k, n):
    """Whisper's and the VLM's cross K/V projections take the wgmma route:
    128 x 128 tiles, whole 32-code steps a split, the splits within route 1's
    limit, shared memory within a block's, pad waste only at M's edge."""
    from repro_torch.obs import telemetry as tm

    pl = k6.plan(m, n, k, 8, 256)
    assert (pl.route, pl.rows, pl.cols) == ("wgmma", k6.WGMMA_TILE, k6.WGMMA_TILE)
    assert pl.tiles == -(-m // 128) * (n // 128)
    assert pl.k_split % k6.MMA_KSTEP == 0
    assert (pl.splits - 1) * pl.k_split < k <= pl.splits * pl.k_split
    assert 1 <= pl.splits <= k6.MMA_MAX_SPLITS
    assert pl.smem == k6.WGMMA_FIXED_SMEM + 2 * 9 * 256 * 4 <= k6.MAX_SMEM
    tel = tm.Telemetry("t")
    with tm.use(tel):
        k6._note_launch(m, n, k, pl)
    assert tel.gauges["axo_matmul.pad_waste"] == pytest.approx(1 - m / (-(-m // 128) * 128))


def test_wgmma_route_boundary_and_alignment():
    """The wgmma route from WGMMA_M rows (the 512-row prefills) where K and N
    are whole multiples of 16 (the TMA's row strides) and its block holds the
    tables; below it, off that alignment or at rank 16, route 1.  Named, it
    refuses K or N off 16 and takes any M above the skinny route's."""
    w = k6.WGMMA_M
    assert k6.plan(w, 1024, 1024, 8, 256).route == "wgmma"
    assert k6.plan(w - 1, 1024, 1024, 8, 256).route == "mma"
    assert k6.plan(512, 8192, 2048, 8, 256).route == "wgmma"     # granite's prefill
    assert k6.plan(512, 22016, 8192, 8, 256).route == "wgmma"    # deepseek-67b's
    assert k6.plan(512, 8192, 2048, 16, 256).route == "mma"      # its tables too large
    assert k6.plan(81, 8192, 2048, 8, 256).route == "mma"
    assert k6.plan(w, 1000, 1024, 8, 256).route == "mma"
    assert k6.plan(w, 1024, 1000, 8, 256).route == "mma"
    assert k6.route_for(6000, 1024, 1024, 8, 256) == "wgmma"
    assert k6.route_for(6000, 1024, 1024, 8, 256) == k6.plan(6000, 1024, 1024, 8, 256).route
    assert k6.plan(128, 8192, 2048, 8, 256, route="wgmma")[:2] == ("wgmma", 128)
    for n, k in ((1000, 1024), (1024, 1000)):
        with pytest.raises(ValueError):
            k6.plan(w, n, k, 8, 256, route="wgmma")


@pytest.fixture
def one_thread():
    """One intra-op thread: the emulations' many small products only contend
    for the cores with the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m, k, n, splits", [(130, 1008, 144, None), (256, 512, 64, 3),
                                             (130, 2048, 32, None)])
@pytest.mark.parametrize("name", ["demo", "random36"])
def test_wgmma_route_sums_hold_the_contract(operators, jax_k6_ref, one_thread, name, m, k, n,
                                            splits):
    """The wgmma route's order (table row by table row over a 32-code step,
    per-step restart, splits in order), on ragged M, N and a K that ends
    half way through a step, holds 1e-5 relative norm against an f64 sum,
    the plain version and the reference's ``ref_axo_matmul_lowrank``."""
    f, g, sv = _tables(operators[name])
    a, b = _codes(m, k, n, m + k + n)
    pl = k6.plan(m, n, k, 8, 256, splits=splits, route="wgmma")
    got = wgmma_emulated(a, b, f, g, sv, pl)
    assert _rel(got, _f64(a, b, f, g, sv)) < REL
    assert _rel(got, k6.axo_matmul(a, b, f, g, sv).double()) < REL
    assert _rel(got, jax_k6_ref(a, b, f, g, sv).double()) < REL


# -- K6's small-M route: one expansion for up to 16 rows, warps along K ----

def small_group_sums(a_codes, b_codes, f, g, sv) -> torch.Tensor:
    """Every 8-code group of K as the small-M route's tensor core sums it, all
    groups at once: (groups, M, N) f32; K is padded to whole 32-code steps
    with codes whose activation values are zero.  Within a group the table
    rows from the last factor down to the values, each factor lo.hi, hi.lo,
    hi.hi (the values' one pass hi.hi): every product is added to the
    accumulator, which rounds toward zero to f32 and starts the group at
    zero.  The operands are split as the kernel splits them: hi = x rounded
    to TF32, lo = x - hi, which the tensor core truncates to TF32."""
    chunk = 8
    (m, k), n = a_codes.shape, b_codes.shape[1]
    kp = -(-k // k6.MMA_KSTEP) * k6.MMA_KSTEP
    runs = kp // chunk
    a = torch.zeros((m, kp), dtype=torch.long)
    a[:, :k] = a_codes.long()
    b = torch.zeros((kp, n), dtype=torch.long)
    b[:k] = b_codes.long()
    rows = []
    for j in range(f.shape[1], -1, -1):
        ta = sv.float() if j == 0 else f[:, j - 1].float()
        tb = sv.float() if j == 0 else g[:, j - 1].float()
        xa = ta[a]
        xa[:, k:] = 0.0
        xb = tb[b]
        ah, bh = tf32_round(xa), tf32_round(xb)
        al, bl = tf32_trunc(xa - ah), tf32_trunc(xb - bh)
        passes = [(ah, bh)] if j == 0 else [(al, bh), (ah, bl), (ah, bh)]
        # (runs, m, chunk) and (runs, chunk, n): each run's slice of K
        rows.append([(x.double().reshape(m, runs, chunk).transpose(0, 1),
                      y.double().reshape(runs, chunk, n)) for x, y in passes])
    acc = torch.zeros((runs, m, n), dtype=torch.float64)
    for passes in rows:
        for x, y in passes:
            acc = _round_toward_zero(acc + x @ y)
    return acc.float()


def small_emulated(a_codes, b_codes, f, g, sv, pl) -> torch.Tensor:
    """The small-M route's sums: a block's 8 warps stand ``pl.cols // 64``
    along N and the rest, W, along K; warp w takes the 4 / W groups of 8 codes
    from group 4w / W of every 32-code step of its split
    (:func:`small_group_sums`) and adds them in IEEE f32 in step order; the
    block adds its W warps' sums in warp order, and the last block of a tile
    the splits' in split order."""
    warps_k = 8 // (pl.cols // 64)
    groups = 4 // warps_k
    sums = small_group_sums(a_codes, b_codes, f, g, sv)
    steps = sums.shape[0] // 4
    per_split = pl.k_split // k6.MMA_KSTEP
    out = None
    for s0 in range(0, steps, per_split):
        block = None
        for w in range(warps_k):
            order = [4 * st + groups * w + gi for st in range(s0, min(steps, s0 + per_split))
                     for gi in range(groups)]
            part = sums[order[0]]
            for i in order[1:]:
                part = part + sums[i]
            block = part if block is None else block + part
        out = block if out is None else out + block
    return out


@pytest.mark.parametrize("m, k, n, splits", [(1, 300, 40, None), (2, 256, 64, 3),
                                             (4, 1000, 77, None), (8, 640, 130, None),
                                             (16, 520, 48, 2), (13, 2048, 96, None),
                                             (3, 96, 4100, 1), (12, 160, 4100, None)])
@pytest.mark.parametrize("name", ["demo", "random36"])
def test_small_route_sums_hold_the_contract(operators, jax_k6_ref, one_thread, name, m, k, n,
                                            splits):
    """The small-M route's order (each 8-code group summed from zero, the
    table rows from the last factor down, a warp's groups in step order, the
    warps along K in warp order, the splits in split order), at M = 1 to
    16 on the plan's own splits or named ones, a ragged N and a K that ends
    inside a step, on both block widths (256 columns, 8 / 4 warps along N and
    K; 512 at N >= SMALL_WIDE_N, every warp along N), holds 1e-5 relative
    norm against an f64 sum, the plain version and the reference's
    ``ref_axo_matmul_lowrank``."""
    f, g, sv = _tables(operators[name])
    a, b = _codes(m, k, n, m + k + n)
    pl = k6.plan(m, n, k, 8, 256, splits=splits)
    assert pl.route == "small" and pl.splits == (splits or pl.splits)
    assert pl.cols == (512 if n >= k6.SMALL_WIDE_N else 256)
    got = small_emulated(a, b, f, g, sv, pl)
    assert _rel(got, _f64(a, b, f, g, sv)) < REL
    assert _rel(got, k6.axo_matmul(a, b, f, g, sv).double()) < REL
    assert _rel(got, jax_k6_ref(a, b, f, g, sv).double()) < REL


def _k7_emulated(q, k, v, kv_len, hi_lo=True):
    """K7's bf16 kernel in plain f32: online softmax over 64-key tiles in the
    exp2 domain, p fed to P.V as bf16 hi + lo (or bf16 alone), output rounded
    once to bf16.  Causal, no offset."""
    b, h, sq, hd = q.shape
    rep = h // k.shape[1]
    kh = k[:, :, :kv_len].float().repeat_interleave(rep, dim=1)
    vh = v[:, :, :kv_len].float().repeat_interleave(rep, dim=1)
    qf = q.float()
    scale = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, kv_len, 64):
        s = qf @ kh[:, :, k0:k0 + 64].transpose(2, 3) * scale
        kpos = torch.arange(k0, min(k0 + 64, kv_len))[None, :]
        s = s.masked_fill(kpos > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p_hi_lo(p) if hi_lo else p.to(torch.bfloat16).float()
        acc = acc * alpha + pv @ vh[:, :, k0:k0 + 64]
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.mark.parametrize("s, cap", [(128, 144), (77, 93)])
def test_k7_hi_lo_p_keeps_the_bf16_contract(s, cap):
    """At the two serve shapes of chip_smoke.py (B=4, H=32, G=8, hd=64), p as
    bf16 hi + lo stays within 2^-7 of max|out| of the plain version, and
    closer than bf16 p alone."""
    rng = np.random.default_rng(s)
    q = torch.from_numpy(rng.standard_normal((4, 32, s, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 8, cap, 64)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    want = k7.flash_attention_plain(q, k, v, kv_len=s).float()
    scale = float(want.abs().max())
    err_pair = float((_k7_emulated(q, k, v, s).float() - want).abs().max()) / scale
    err_bf16 = float((_k7_emulated(q, k, v, s, hi_lo=False).float() - want).abs().max()) / scale
    assert err_pair <= 2.0 ** -7, err_pair
    assert err_pair <= err_bf16, (err_pair, err_bf16)


def k7_wgmma_emulated(q, k, v, *, causal: bool) -> torch.Tensor:
    """K7's wgmma route in plain f32: an online softmax over 128-key tiles in
    the exp2 domain, the row sums of f32 p, p rounded once to bf16 for P.V
    (the TPU kernel's ``p.astype(v.dtype)``), the output rounded once to
    bf16.  A causal block scans the tiles up to its last row's key; a row
    that has seen no key yet keeps its sums at 0 (the kernel's base of 0)."""
    b, h, sq, hd = q.shape
    skv = k.shape[2]
    rep = h // k.shape[1]
    kh = k.float().repeat_interleave(rep, dim=1)
    vh = v.float().repeat_interleave(rep, dim=1)
    scale = math.log2(math.e) / math.sqrt(hd)
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, hd))
    qpos = torch.arange(sq)[:, None]
    kend = min(skv, sq) if causal else skv
    for k0 in range(0, kend, k7.WGMMA_KEYS):
        k1 = min(k0 + k7.WGMMA_KEYS, skv)
        s = q.float() @ kh[:, :, k0:k1].transpose(2, 3) * scale
        if causal:
            s = s.masked_fill(torch.arange(k0, k1)[None, :] > qpos, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vh[:, :, k0:k1]
        m = m_new
    return (acc / l).to(torch.bfloat16)


@pytest.fixture(scope="module")
def jax_k7_ref():
    """The reference's ``ref_flash_attention`` (needs JAX): bf16 in, p
    rounded to bf16 before P.V."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ref import ref_flash_attention

    def run(q, k, v, causal):
        args = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
        out = ref_flash_attention(*args, causal=causal)
        return torch.from_numpy(np.array(out.astype(jnp.float32)))

    return run


# the wgmma route's shapes with their heads cut to fit the CPU: whisper's
# encoder (1,500 x 1,500, hd 64), the VLM's cross-attention (128 x 1,600,
# hd 128, 8 query heads a KV group) and granite's 4,096-token causal forward
K7_WGMMA_SHAPES = {"whisper encoder": (1, 2, 2, 1500, 1500, 64, False),
                   "vlm cross": (1, 8, 1, 128, 1600, 128, False),
                   "causal 4096": (1, 1, 1, 4096, 4096, 64, True)}


@pytest.mark.parametrize("name", sorted(K7_WGMMA_SHAPES))
def test_k7_wgmma_bf16_p_keeps_the_bf16_contract(jax_k7_ref, name):
    """p rounded once to bf16 over 128-key tiles stays within 2^-7 of
    max|out| of the plain version (f32 p) and of the reference (bf16 p)."""
    b, h, g, sq, skv, hd, causal = K7_WGMMA_SHAPES[name]
    rng = np.random.default_rng(sq + skv)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((b, h, sq, hd), (b, g, skv, hd), (b, g, skv, hd)))
    assert k7.plan(4, 16 * h, sq, skv, hd, causal).route == "wgmma"
    got = k7_wgmma_emulated(q, k, v, causal=causal).float()
    for want in (k7.flash_attention_plain(q, k, v, causal=causal).float(),
                 jax_k7_ref(q, k, v, causal)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 2.0 ** -7 * scale


def k7_stacked_emulated(q, k, v, kv_len: int, heads: int) -> torch.Tensor:
    """K7's head-stacked route in plain f32, causal, no offset: each block
    owns 64 query rows of ``heads`` heads of one KV group (so the group's K/V
    tiles of 128 keys serve them all); q, K and V are zero-filled to 128
    columns (hd 112: the TMA's fill past the map's width) and only the heads'
    own columns are stored.  Per head the online softmax of
    :func:`k7_wgmma_emulated` over the tiles up to the block's last row."""
    b, h, sq, hd = q.shape
    rep = h // k.shape[1]
    assert rep % heads == 0

    def wide(x):
        return torch.nn.functional.pad(x.float(), (0, 128 - hd))
    qw, kw, vw = wide(q), wide(k[:, :, :kv_len]), wide(v[:, :, :kv_len])
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty((b, h, sq, hd))
    for r0 in range(0, sq, k7.WGMMA_ROWS):
        r1 = min(sq, r0 + k7.WGMMA_ROWS)
        qpos = torch.arange(r0, r1)[:, None]
        kend = min(kv_len, r1)
        for h0 in range(0, h, heads):          # one block: heads h0 .. h0 + heads - 1
            grp = h0 // rep
            kb, vb = kw[:, grp], vw[:, grp]     # the tiles every warpgroup reads
            for hh in range(h0, h0 + heads):
                m = torch.full((b, r1 - r0, 1), -math.inf)
                l = torch.zeros((b, r1 - r0, 1))
                acc = torch.zeros((b, r1 - r0, 128))
                for k0 in range(0, kend, k7.WGMMA_KEYS):
                    k1 = min(k0 + k7.WGMMA_KEYS, kv_len)
                    s = qw[:, hh, r0:r1] @ kb[:, k0:k1].transpose(1, 2) * scale
                    s = s.masked_fill(torch.arange(k0, k1)[None, :] > qpos, -math.inf)
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    base = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
                    alpha = torch.exp2(m - base)
                    p = torch.exp2(s - base)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + p.to(torch.bfloat16).float() @ vb[:, k0:k1]
                    m = m_new
                out[:, hh, r0:r1] = (acc / l)[..., :hd]
    return out.to(torch.bfloat16)


# K7's four short causal prefills at hd 128 and 112 (chip_smoke.py K7_WIDE):
# query heads, KV groups, hd, and on the H100 the heads a stacked block holds
# at once and walks in all
K7_WIDE = {"internlm2-1.8b": (16, 8, 128, 1, 1), "starcoder2-3b": (24, 2, 128, 2, 2),
           "deepseek-67b": (64, 8, 128, 2, 4), "kimi-k2-1t-a32b": (64, 8, 112, 2, 4)}


@pytest.mark.parametrize("name", sorted(K7_WIDE))
def test_k7_stacked_plan_at_the_wide_prefills(name):
    """B=4, S=128 over 128 of a 136-slot cache: the head-stacked route in the
    fewest waves of blocks times rounds (deepseek-67b, kimi-k2: 128 blocks of
    two heads at once, two rounds; starcoder2: 96 blocks of two; internlm2:
    128 blocks of one), its blocks' heads within one KV group; its pad waste
    is that of 64 x 128 tiles (none here)."""
    from repro_torch.obs import telemetry as tm

    h, g, hd, at_once, heads = K7_WIDE[name]
    pl = k7.plan(4, h, 128, 128, hd, True, groups=g)
    assert pl == ("stacked", 64 * at_once, 128, heads)
    assert (h // g) % heads == 0 and 4 * 2 * h // heads <= k7.H100_SMS
    tel = tm.Telemetry("t")
    with tm.use(tel):
        k7._record_pad(pl, 128, 128)
        k7._record_pad(pl, 77, 77)
    assert tel.histogram_summary("flash_attention.pad_waste")["count"] == 2
    assert tel.gauges["flash_attention.pad_waste"] == pytest.approx(1 - 77 ** 2 / (128 * 128))


@pytest.mark.parametrize("hd, heads", [(128, 2), (112, 2), (128, 1)])
@pytest.mark.parametrize("s, cap", [(128, 136), (77, 93)])
def test_k7_stacked_tiles_keep_the_bf16_contract(jax_k7_ref, one_thread, hd, heads, s, cap):
    """The head-stacked tiles (hd 112 zero-filled to 128) at causal S = 128
    and 77 over a longer cache stay within 2^-7 of max|out| of the plain
    version and of the reference; at hd 128 they give the bits of the
    per-head wgmma tiles (a fully masked tile changes nothing)."""
    rng = np.random.default_rng(s + hd + heads)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, 8, s, hd), (1, 2, cap, hd), (1, 2, cap, hd)))
    got = k7_stacked_emulated(q, k, v, s, heads)
    want = k7.flash_attention_plain(q, k, v, kv_len=s).float()
    ref = jax_k7_ref(q, k[:, :, :s], v[:, :, :s], True)
    for w in (want, ref):
        assert float((got.float() - w).abs().max()) <= 2.0 ** -7 * float(w.abs().max())
    if hd == 128:
        assert torch.equal(got, k7_wgmma_emulated(q, k[:, :, :s], v[:, :, :s], causal=True))


def test_k7_plan_routes_by_shape():
    """The wgmma route takes the non-causal calls and the long causal ones at
    hd 64 and 128, in blocks of the most query rows (192 at hd 64, 128 at hd
    128) whose blocks fill the card, else 64; granite's S=128 causal prefill
    keeps the mma route, as do the reduced configs' 16; the short causal
    prefills at hd 112 (kimi-k2) and 128 (internlm2) take the head-stacked
    route; f32 takes the f32 kernel."""
    assert k7.plan(4, 32, 128, 128, 64, True) == ("mma", 64, 64, 1)     # granite prefill
    assert k7.plan(4, 64, 128, 128, 112, True).route == "stacked"         # kimi-k2
    assert k7.plan(4, 16, 128, 128, 128, True).route == "stacked"         # internlm2
    assert k7.plan(4, 64, 512, 512, 112, True).route == "mma"             # hd 112, long
    assert k7.plan(4, 16, 1500, 1500, 64, False) == ("wgmma", 192, 128, 1)  # whisper encoder
    assert k7.plan(4, 16, 128, 1500, 64, False) == ("wgmma", 64, 128, 1)    # whisper cross
    assert k7.plan(4, 64, 128, 1600, 128, False) == ("wgmma", 128, 128, 1)  # the VLM's cross
    assert k7.plan(4, 32, 4096, 4096, 64, True) == ("wgmma", 192, 128, 1)   # granite 4 x 4096
    assert k7.plan(1, 16, 1500, 1500, 64, False) == ("wgmma", 128, 128, 1)  # 128 rows fill it
    assert k7.plan(1, 16, 1500, 1500, 64, False, n_sms=64).rows == 192
    assert k7.plan(1, 2, 40, 40, 16, False).route == "mma"
    assert k7.plan(4, 32, 128, 128, 64, True, bf16=False).route == "f32"
    c = k7.WGMMA_CAUSAL_KV
    assert k7.plan(4, 32, c, c, 64, True).route == "wgmma"
    assert k7.plan(4, 32, c - 1, c - 1, 64, True).route == "mma"
    assert k7.plan(4, 32, 128, 128, 64, True, route="wgmma")[:1] == ("wgmma",)
    for kw in (dict(hd=112, route="wgmma"), dict(hd=64, route="f32"), dict(hd=64, route="x"),
               dict(hd=64, route="stacked")):
        with pytest.raises(ValueError):
            k7.plan(4, 32, 128, 128, kw["hd"], True, route=kw["route"])
    with pytest.raises(ValueError):
        k7.plan(4, 32, 128, 0, 64, False, route="wgmma")


def test_k7_pad_waste_on_the_route_tiles():
    """The wrapper records pad waste on its plan's tiles: 64 x 64 on the
    mma and f32 routes, (64, 128 or 192) x 128 on the wgmma route."""
    from repro_torch.obs import telemetry as tm

    tel = tm.Telemetry("t")
    with tm.use(tel):
        k7._record_pad(k7.plan(4, 16, 1500, 1500, 64, False), 1500, 1500)
    # whisper's encoder: 1,500 queries in 8 blocks of 192, 1,500 keys in 12 tiles of 128
    assert tel.gauges["flash_attention.pad_waste"] == pytest.approx(1 - 1500 ** 2 / 1536 ** 2)
    with tm.use(tel):
        k7._record_pad(k7.plan(4, 32, 128, 128, 64, True), 128, 128)
    assert tel.gauges["flash_attention.pad_waste"] == 0.0


def test_k7_traced_call_records_the_h100_plan_once():
    """A call traced on fake CUDA tensors (the dry-run) launches nothing and
    plans nowhere in the wrapper: the op's fake implementation records the
    pad waste of the H100's plan (whisper's encoder, 192 x 128 wgmma blocks),
    once a shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.obs import telemetry as tm

    tel = tm.Telemetry("t")
    with tm.use(tel), FakeTensorMode():
        q = torch.empty(4, 1500, 16, 64, dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        kv = torch.empty(4, 1500, 16, 64, dtype=torch.bfloat16, device="cuda").transpose(1, 2)
        for _ in range(2):
            k7.flash_attention(q, kv, kv, causal=False)
    assert tel.gauges["flash_attention.pad_waste"] == pytest.approx(1 - 1500 ** 2 / 1536 ** 2)
    assert tel.histogram_summary("flash_attention.pad_waste")["count"] == 1


def test_p_hi_lo_carries_sixteen_bits():
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.random(10000).astype(np.float32))
    rel = ((p_hi_lo(p) - p).abs() / p).max()
    assert float(rel) <= 2.0 ** -16


# -- K8's bf16 tensor-core route, emulated ----------------------------------

def bf16_terms(v: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """f32 -> ``terms`` bf16 values (as f32), each the rest of the ones before
    rounded to bf16, as the kernel's ``split3`` makes them (terms=3)."""
    out, rest = [], v
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _k8_sum(product, k: int, terms: int) -> torch.Tensor:
    """The kernel's sum over k: per 16-wide k step and per bf16 term, one MMA
    from a zeroed accumulator (its products exact, its result rounded to f32
    here), the terms added small first, the step added to the running f32
    sum.  ``product(k0, k1, term)`` gives one step's exact product in f64."""
    acc = None
    for k0 in range(0, k, 16):
        parts = [product(k0, min(k0 + 16, k), t).float() for t in range(terms)]
        step = parts[0]
        if terms > 1:
            rest = parts[-1]
            for part in reversed(parts[1:-1]):
                rest = part + rest
            step = parts[0] + rest
        acc = step if acc is None else acc + step
    return acc


def k8_emulated(x, dt, a, bmat, cmat, init=None, terms=3):
    """K8's bf16 route in plain torch, over its 32-position chunks: the
    scores C B^T (bf16 operands, one pass); y = M x + exp(cs) C state^T and
    the state update (w x)^T B with M, the state and w x each as ``terms``
    bf16 terms.  Returns (y in f32 before its rounding to bf16, the f32
    state)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    q = k8.CHUNK
    pad = (-s) % q
    x, bmat, cmat = (torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
                     for t in (x, bmat, cmat))
    dt = torch.nn.functional.pad(dt.float(), (0, 0, 0, pad))
    state = torch.zeros((b, h, p, n)) if init is None else init.float().clone()
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, s + pad, q):
        xc, dtc = x[:, c0:c0 + q], dt[:, c0:c0 + q]                   # (B, Q, H, P), (B, Q, H)
        bh = bmat[:, c0:c0 + q].repeat_interleave(rep, dim=2).double()  # (B, Q, H, N)
        ch = cmat[:, c0:c0 + q].repeat_interleave(rep, dim=2).double()
        scores = _k8_sum(lambda k0, k1, t: torch.einsum(
            "blhn,bshn->bhls", ch[..., k0:k1], bh[..., k0:k1]), n, 1)   # (B, H, Q, Q)
        cs = torch.cumsum(dtc * a.float(), dim=1)                       # (B, Q, H)
        last = cs[:, -1]
        seg = cs.transpose(1, 2)[..., :, None] - cs.transpose(1, 2)[..., None, :]
        m = scores * torch.exp(seg.masked_fill(~tri, 0.0)) * dtc.transpose(1, 2)[..., None, :]
        m = m.masked_fill(~tri, 0.0)
        m_t = [t.double() for t in bf16_terms(m, terms)]
        st_t = [t.double() for t in bf16_terms(state, terms)]
        xd = xc.double()
        diag = _k8_sum(lambda k0, k1, t: torch.einsum(
            "bhls,bshp->blhp", m_t[t][..., k0:k1], xd[:, k0:k1]), q, terms)
        off = _k8_sum(lambda k0, k1, t: torch.einsum(
            "blhn,bhpn->blhp", ch[..., k0:k1], st_t[t][..., k0:k1]), n, terms)
        ys.append(diag + off * torch.exp(cs)[..., None])
        w = torch.exp(last[:, None] - cs) * dtc
        wx_t = [t.double() for t in bf16_terms(xc * w[..., None], terms)]
        upd = _k8_sum(lambda k0, k1, t: torch.einsum(
            "bshp,bshn->bhpn", wx_t[t][:, k0:k1], bh[:, k0:k1]), q, terms)
        state = (state.double() * torch.exp(last).double()[..., None, None]
                 + upd.double()).float()                                # one rounding: fmaf
    return torch.cat(ys, dim=1)[:, :s], state


def _k8_inputs(b, s, h, g, p, n, seed):
    """bf16 x, B, C and f32 dt, a, drawn as the reference's kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    x, bm, cm = (t.to(torch.bfloat16) for t in (f(b, s, h, p), f(b, s, g, n), f(b, s, g, n)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    return x, dt, a, bm, cm


def test_three_bf16_terms_carry_f32():
    rng = np.random.default_rng(4)
    v = torch.from_numpy((rng.standard_normal(10000) * 10.0 ** rng.uniform(-6, 6, 10000))
                         .astype(np.float32))
    three = sum(bf16_terms(v, 3))
    assert float(((three - v).abs() / v.abs()).max()) <= 2.0 ** -24
    two = sum(bf16_terms(v, 2))
    assert float(((two - v).abs() / v.abs()).max()) <= 2.0 ** -16


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's sequential scan and Pallas kernel (they need JAX)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.ops import ssd_scan as pallas_ssd_scan
    from repro.kernels.ref import ref_ssd_scan

    def run(fn, *args, **kw):
        y, st = fn(*(jnp.asarray(t.float().numpy()) for t in args), **kw)
        return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(st))

    return {"ref": lambda *t: run(ref_ssd_scan, *t),
            "pallas": lambda *t: run(pallas_ssd_scan, *t, chunk=128, interpret=True)}


@pytest.mark.parametrize("s", [256, 300])
def test_k8_three_term_route_holds_the_contracts(jax_ref, s):
    """At the mamba2 head (P=64, N=128), K8's chunk of 32, S=256 and a ragged
    300: y within 1e-5 of max|y| before its bf16 rounding and within 2^-7
    after it, the state within 1e-5 relative norm, against the reference's
    sequential scan and (S=256) its Pallas kernel in interpret mode."""
    x, dt, a, bm, cm = _k8_inputs(1, s, 2, 1, 64, 128, s)
    y, st = k8_emulated(x, dt, a, bm, cm)
    for name in ["ref", "pallas"] if s % 128 == 0 else ["ref"]:
        y_ref, st_ref = jax_ref[name](x, dt, a, bm, cm)
        scale = float(y_ref.abs().max())
        assert float((y - y_ref).abs().max()) <= 1e-5 * scale, name
        y_bf16 = y.to(torch.bfloat16).float()
        assert float((y_bf16 - y_ref).abs().max()) <= 2.0 ** -7 * scale, name
        assert _rel(st, st_ref.double()) <= REL, name


def _ssd_f64(x, dt, a, bmat, cmat):
    """The recurrence step by step in f64: (y, final state)."""
    b, s, h, p = x.shape
    rep = h // bmat.shape[2]
    bh, ch = (t.double().repeat_interleave(rep, dim=2) for t in (bmat, cmat))
    st = torch.zeros((b, h, p, bmat.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(s):
        d = dt[:, t].double()
        st = (st * torch.exp(d * a.double())[..., None, None]
              + (d[..., None] * x[:, t].double())[..., None] * bh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], st))
    return torch.stack(ys, dim=1), st


def test_k8_three_terms_are_as_close_as_f32():
    """Against the f64 recurrence at the mamba2 head (S=300): three bf16
    terms keep y and the state as close as the plain f32 scan at K8's chunk
    does (within 2x), and y rounds to the same bf16 about as often; a hi + lo
    pair (2^-16) is over 10x further off and flips over 10x more bf16
    roundings of y, each of which the full-width model amplifies."""
    x, dt, a, bm, cm = _k8_inputs(1, 300, 2, 1, 64, 128, 300)
    y_t, st_t = _ssd_f64(x, dt, a, bm, cm)
    y_f32, st_f32 = k8.ssd_scan_plain(x.float(), dt, a, bm.float(), cm.float(), chunk=k8.CHUNK)
    y3, st3 = k8_emulated(x, dt, a, bm, cm, terms=3)
    y2, _ = k8_emulated(x, dt, a, bm, cm, terms=2)

    def flips(y):
        return float((y.to(torch.bfloat16) != y_t.float().to(torch.bfloat16)).float().mean())

    assert _rel(y3, y_t) <= 2 * _rel(y_f32, y_t)
    assert _rel(st3, st_t) <= 2 * _rel(st_f32, st_t)
    assert flips(y3) <= 2 * flips(y_f32)
    assert _rel(y2, y_t) > 10 * _rel(y3, y_t)
    assert flips(y2) > 10 * flips(y3)


def test_k8_hi_lo_pair_holds_the_kernel_contracts():
    """A hi + lo pair per f32 operand (two tensor-core passes) would still
    hold K8's own contracts at the mamba2 head (S=300): y in bf16 within
    2^-7 of max|y| and the state within 1e-5 relative norm of the f64
    recurrence.  So the least tensor-core work for the scan counts two
    passes, not the three the kernel spends, and K8's bound is by bytes."""
    x, dt, a, bm, cm = _k8_inputs(1, 300, 2, 1, 64, 128, 300)
    y_t, st_t = _ssd_f64(x, dt, a, bm, cm)
    y2, st2 = k8_emulated(x, dt, a, bm, cm, terms=2)
    scale = float(y_t.abs().max())
    assert float((y2.to(torch.bfloat16).double() - y_t).abs().max()) <= 2.0 ** -7 * scale
    assert _rel(st2, st_t) <= REL


def test_k8_emulation_with_an_entering_state_and_groups(jax_ref):
    """Two groups of two heads, an entering state, ragged S at K8's chunk."""
    x, dt, a, bm, cm = _k8_inputs(2, 77, 4, 2, 16, 32, 7)
    init = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 4, 16, 32))
                            .astype(np.float32))
    y, st = k8_emulated(x, dt, a, bm, cm, init=init)
    y_ref, st_ref = jax_ref["ref"](x, dt, a, bm, cm, init)
    assert float((y - y_ref).abs().max()) <= 1e-5 * float(y_ref.abs().max())
    assert _rel(st, st_ref.double()) <= REL


# -- K4's staged route, emulated -------------------------------------------

K4_SLAB, K4_CHUNK = k4.STAGED_SLAB, k4.STAGED_CHUNK
# the apps' table-route shapes: (M, K, N), and M*N*K lookups per config
APP_SHAPES = {"mnist head": (250, 256, 10), "ffn GEMM1": (96, 64, 128),
              "gauss conv2d": (8464, 25, 1), "ecg conv1d": (2034, 15, 1)}


def k4_stage_pass(table: torch.Tensor, n_bits: int, h: int) -> torch.Tensor:
    """The shared-memory image of pass ``h`` of one config's (A*B,) table,
    written as the kernel's ``stage_table`` writes it: 16-byte chunks of 4
    entries, chunk (a, b0) into slot (a_local * B + (b0 ^ (a & ~3))), its
    entries permuted by XOR with a & 3.  Entry (a, b) lands at
    a_local * B + (b ^ a)."""
    nb = 1 << n_bits
    rows = min(nb, k4.STAGED_PASS_ROWS)
    src = table[h * rows * nb:(h + 1) * rows * nb].reshape(-1, 4)
    e = torch.arange(src.shape[0]) * 4
    al = e >> n_bits
    a = h * rows + al
    slot = (al << n_bits) + ((e & (nb - 1)) ^ (a & (nb - 1) & ~3))
    tsh = torch.empty(rows * nb, dtype=table.dtype)
    for i in range(4):
        tsh[slot + (i ^ (a & 3))] = src[:, i]
    return tsh


def k4_staged_emulated(tables_flat: torch.Tensor, a_codes: torch.Tensor,
                       b_codes: torch.Tensor) -> torch.Tensor:
    """K4's staged route in plain torch: the codes packed as uint8 (A in
    whole 32-row slabs, K in whole 16-code chunks, zero-padded); per table
    half that the packed A codes use, the swizzled shared-memory image, each
    lookup's pass index (a << 8 | (a ^ b)) ^ (h << 15)
    taken only where it falls in the pass's half (the kernel predicates the
    other lookups off), padded K's T(0, 0) subtracted in the first half, the
    two passes' sums added (in shared memory on the card); sums wrap modulo
    2^32 as the kernel's unsigned ones."""
    d, ab = tables_flat.shape
    n_bits = (ab.bit_length() - 1) // 2
    nb = 1 << n_bits
    (m, k), n = a_codes.shape, b_codes.shape[1]
    m_pad = -(-m // K4_SLAB) * K4_SLAB
    k_pad = -(-k // K4_CHUNK) * K4_CHUNK
    a8 = torch.zeros((m_pad, k_pad), dtype=torch.int64)
    a8[:m, :k] = a_codes.long() & (nb - 1)
    bt8 = torch.zeros((n, k_pad), dtype=torch.int64)
    bt8[:, :k] = (b_codes.long() & (nb - 1)).T
    pass_ints = min(nb, k4.STAGED_PASS_ROWS) * nb
    used = sorted(set((a8 >> 7).flatten().tolist()))          # the packing's flags
    out = torch.zeros((d, m_pad, n), dtype=torch.int64)
    av, bv = a8[:, None, :], bt8[None, :, :]                  # (M_pad, 1, K), (1, N, K)
    for h in used:
        if n_bits == 8:
            idx = (((av << 8) | (av ^ bv)) ^ (h << 15)) & 0xFFFF
        else:
            idx = (av << n_bits) | (av ^ bv)
        hit = idx < pass_ints
        idx = torch.where(hit, idx, 0)
        for c in range(d):
            tsh = k4_stage_pass(tables_flat[c].long(), n_bits, h)
            part = (tsh[idx] * hit).sum(-1)
            if h == 0:
                part -= (k_pad - k) * tsh[0]
            out[c] += part
    out = out[:, :m] & 0xFFFFFFFF
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _k4_tables(n_bits, n_cfgs, seed):
    spec = ref_spec_for(n_bits)
    cfgs = np.random.default_rng(seed).integers(0, 2, (n_cfgs, spec.n_luts)).astype(np.uint8)
    return ref_product_tables(spec, cfgs)


def _k4_check(tables, a, b):
    got = k4_staged_emulated(torch.from_numpy(tables.reshape(len(tables), -1).astype(np.int32)),
                             torch.from_numpy(a.astype(np.int32)),
                             torch.from_numpy(b.astype(np.int32)))
    tflat = torch.from_numpy(tables.reshape(len(tables), -1).astype(np.int32))
    plain = k4.table_gemv_plain(tflat, torch.from_numpy(a.astype(np.int32)),
                                torch.from_numpy(b.astype(np.int32)))
    assert torch.equal(got, plain)
    want = np.stack([ref_table_matmul(t, a & (t.shape[0] - 1), b & (t.shape[1] - 1))
                     for t in tables])
    np.testing.assert_array_equal(got.numpy(), want)


def test_k4_stage_pass_places_entry_a_b_at_b_xor_a():
    tab = torch.arange(1 << 16, dtype=torch.int64)
    for h in (0, 1):
        tsh = k4_stage_pass(tab, 8, h)
        a = torch.arange(128)[:, None] + 128 * h
        b = torch.arange(256)[None, :]
        assert torch.equal(tsh[((a - 128 * h) << 8) | (b ^ a)], a * 256 + b)
    tsh = k4_stage_pass(torch.arange(256, dtype=torch.int64), 4, 0)
    a, b = torch.arange(16)[:, None], torch.arange(16)[None, :]
    assert torch.equal(tsh[(a << 4) | (b ^ a)], a * 16 + b)


@pytest.mark.parametrize("name", sorted(APP_SHAPES))
def test_k4_staged_route_matches_plain_and_reference(name):
    """The four app shapes with 3 configs: codes of both halves, of the low
    half only (as the apps' non-negative inputs) and out-of-range codes
    (taken modulo 2^8)."""
    m, k, n = APP_SHAPES[name]
    tables = _k4_tables(8, 3, 5)
    rng = np.random.default_rng(m + k)
    b = rng.integers(0, 256, (k, n))
    for a in (rng.integers(0, 256, (m, k)), rng.integers(0, 128, (m, k)),
              rng.integers(-700, 900, (m, k))):
        _k4_check(tables, a, b)


@pytest.mark.parametrize("m, k, n", [(23, 100, 7), (64, 32, 3), (33, 17, 16), (1, 1, 1)])
def test_k4_staged_route_ragged_and_one_half(m, k, n):
    """Ragged M and K, and (64, 32, 3) whole slabs and chunks with every a
    code in the high half: a single pass over half 1, no padding to subtract."""
    tables = _k4_tables(8, 2, m)
    rng = np.random.default_rng(k)
    b = rng.integers(0, 256, (k, n))
    _k4_check(tables, rng.integers(0, 256, (m, k)), b)
    _k4_check(tables, rng.integers(128, 256, (m, k)), b)


def test_k4_staged_route_at_four_bits():
    tables = _k4_tables(4, 4, 9)
    rng = np.random.default_rng(9)
    _k4_check(tables, rng.integers(-40, 40, (70, 37)), rng.integers(0, 16, (37, 5)))


@pytest.mark.parametrize("name", sorted(APP_SHAPES))
def test_k4_plan_at_the_app_shapes(name):
    """The staged route where a config makes at least STAGED_MIN_REUSE
    lookups per table entry (mnist 9.8, ffn 12.0, gauss 3.2), the gather
    route at the ecg conv (0.47); the staged plan fits shared memory."""
    m, k, n = APP_SHAPES[name]
    pl = k4.plan(m, k, n, 8)
    reuse = m * k * n / 65536
    assert pl.route == ("staged" if reuse >= k4.STAGED_MIN_REUSE else "gather")
    assert pl.route == ("gather" if name == "ecg conv1d" else "staged")
    staged = k4.plan(m, k, n, 8, "staged")
    assert staged.smem == k4._staged_smem(m, k, n, 8) <= k4.MAX_SMEM
    gather = k4.plan(m, k, n, 8, "gather")
    assert (gather.m_tile, gather.k_tile) == k4._tiles(m, k, n, 0)


def test_k4_plan_boundary_and_limits():
    """The boundary is M*N*K = STAGED_MIN_REUSE * 4^n_bits; a shape whose
    staged plan exceeds shared memory, or 1-bit codes, takes the gather
    route, and naming the staged route for it raises."""
    edge = math.ceil(k4.STAGED_MIN_REUSE * 65536 / 64)     # M at K=64, N=1
    assert k4.plan(edge, 64, 1, 8).route == "staged"
    assert k4.plan(edge - 1, 64, 1, 8).route == "gather"
    assert k4.plan(4096, 1024, 10, 8).route == "gather"        # 2 tiles of 3 slabs x 1 KiB rows
    with pytest.raises(ValueError, match="staged route cannot"):
        k4.plan(4096, 1024, 10, 8, "staged")
    assert k4.plan(40000, 16, 1, 8).route == "gather"          # the sums, 160 KB, do not fit
    assert k4.plan(4000, 100, 10, 1).route == "gather"
    for route in ("tiles", "cluster"):
        with pytest.raises(ValueError, match="unknown"):
            k4.plan(10, 10, 10, 8, route)
    # the layout's A tiles hold 15 // N + 2 slabs: a round's 16 items (slab-
    # major, N a slab) span at most that many
    for n in (1, 3, 10, 16, 17, 128):
        slabs = [((r * 16 + 15) // n) - (r * 16 // n) + 1 for r in range(64)]
        assert max(slabs) <= (k4.STAGED_WARPS - 1) // n + 2


# -- K1's register walk, emulated -------------------------------------------

def _pair(a, r):
    return (((a >> (2 * r)) & 1) << 1) | ((a >> (2 * r + 1)) & 1)


def exact_float(v: torch.Tensor) -> torch.Tensor:
    """|e| to f32 as the kernel does it: (0x4B000000 | v) read as f32, minus 2^23."""
    return (v.to(torch.int32) | 0x4B000000).view(torch.float32) - 8388608.0


def k1_walk_emulated(small, exact, w, a_tile):
    """K1's register walk in plain torch, per A-tile and per group of 2^GB
    codes (GB = min(log2 a_tile, 6)): the base from the rows whose bit pairs
    the group fixes, a half row whose low bit varies when GB is odd, and the
    rows held in registers indexed by the walk's compile-time pair indices.
    Returns K1's (n_ta, D, 8) int32 and f32 partials."""
    rows, d, _, b = small.shape
    n_bits = b.bit_length() - 1
    gb = min(a_tile.bit_length() - 1, 6)
    full, half = gb // 2, gb % 2
    sm = small.long()
    shifted = [sm[r] << (2 * r) for r in range(rows)]      # (D, 4, B) each
    n_ta = b // a_tile
    int_p = torch.zeros((n_ta, d, 8), dtype=torch.int32)
    rel_p = torch.zeros((n_ta, d, 8), dtype=torch.float32)
    for j in range(n_ta):
        errs, ws = [], []
        for a0 in range(j * a_tile, (j + 1) * a_tile, 1 << gb):
            base = sum((shifted[r][:, _pair(a0, r)] for r in range(full + half, rows)),
                       torch.zeros((d, b), dtype=torch.int64))
            f = (a0 >> gb) & 1
            for i in range(1 << gb):
                approx = base.clone()
                if half:
                    approx += shifted[full][:, 2 * ((i >> (gb - 1)) & 1) + f]
                for r in range(full - 1, -1, -1):
                    approx += shifted[r][:, _pair(i, r)]
                errs.append(approx - exact[a0 + i].long())
                ws.append(w[a0 + i])
        err = torch.stack(errs, 1)                          # (D, a_tile, B)
        ae = err.abs()
        hi, lo = ae >> 8, ae & 255
        int_p[j, :, 0] = ae.sum((1, 2)).int()
        int_p[j, :, 1] = (err != 0).sum((1, 2)).int()
        int_p[j, :, 2] = ae.amax((1, 2)).int()
        int_p[j, :, 3] = (hi * hi).sum((1, 2)).int()
        int_p[j, :, 4] = (hi * lo).sum((1, 2)).int()
        int_p[j, :, 5] = (lo * lo).sum((1, 2)).int()
        rel_p[j, :, 0] = (exact_float(ae) * torch.stack(ws)[None]).sum((1, 2))
    return int_p, rel_p


def test_exact_float_converts_every_error_exactly():
    v = torch.cat([torch.arange(70000), torch.tensor([2**23 - 1, 43520, 123457])])
    assert torch.equal(exact_float(v), v.to(torch.float32))


@pytest.mark.parametrize("n_bits", [2, 4, 6, 8])
def test_k1_walk_matches_plain_and_reference(n_bits):
    """At the default a_tile of each width (4, 16, 64, 64) and at a_tile 8
    (an odd GB: the half row), on 9 random configs plus the accurate and the
    all-zeros one: int channels exactly, the f32 channel to 1e-5, against
    the plain version and the reference's XLA twin ``_partials_xla``."""
    spec = spec_for(n_bits)
    rng = np.random.default_rng(n_bits)
    cfgs = np.concatenate([rng.integers(0, 2, (9, spec.n_luts)).astype(np.uint8),
                           np.ones((1, spec.n_luts), np.uint8),
                           np.zeros((1, spec.n_luts), np.uint8)])
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32))
    small = fastchar._gather_small(masks, n_bits)
    _, exact, w = fastchar._device_tables(n_bits, "cpu")
    tiles = {fastchar.default_a_tile(spec), min(8, 1 << n_bits)}
    for a_tile in sorted(tiles):
        got_i, got_r = k1_walk_emulated(small, exact, w, a_tile)
        want_i, want_r = k1.behav_stats_table_plain(small, exact, w, a_tile)
        assert torch.equal(got_i, want_i), a_tile
        torch.testing.assert_close(got_r, want_r, rtol=1e-5, atol=0)
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import fastchar as ref_fastchar

    a_tile = fastchar.default_a_tile(spec)
    ref_i, ref_r = ref_fastchar._partials_xla(jnp.asarray(masks.numpy()), n_bits, a_tile,
                                              len(cfgs))
    got_i, got_r = k1_walk_emulated(small, exact, w, a_tile)
    np.testing.assert_array_equal(np.asarray(ref_i), got_i.numpy())
    np.testing.assert_allclose(np.asarray(ref_r), got_r.numpy(), rtol=1e-5)


# -- The closed-form carry chain of K5's and K2's redesigns -----------------

def chain_closed_form(t1, t2, mask, n_bits):
    """``operator_model._chain_eval`` as ``rowplanes::Column`` computes it:
    ((t1 & keep) + (t2 & keep)) & keep, keep = the mask's removable columns
    0..n_bits and the sign column n_bits + 1, read as W-bit two's complement."""
    sign = 1 << (n_bits + 1)
    keep = (mask & (sign - 1)) | sign
    s = ((t1 & keep) + (t2 & keep)) & keep
    return (s ^ sign) - sign


def closed_form_planes(masks: torch.Tensor, n_bits: int) -> torch.Tensor:
    """(D, R) masks -> (R, D, 4, B) planes, each value in closed form from
    the column's operands B, +B << 1 and -B << 1 (the last row subtracts)."""
    spec = spec_for(n_bits)
    nb = 1 << n_bits
    modw = (1 << spec.width) - 1
    b = torch.arange(nb, dtype=torch.int64)
    bs = torch.where(b >= nb // 2, b - nb, b)
    out = []
    for r in range(spec.rows):
        bx = -bs if r == spec.rows - 1 else bs
        mask = masks[:, r].long()[:, None]
        planes = [chain_closed_form((bs & modw) * (p >> 1), ((bx << 1) & modw) * (p & 1),
                                    mask, n_bits) for p in range(4)]
        out.append(torch.stack(planes, 1))                   # (D, 4, B)
    return torch.stack(out).to(torch.int32)


def test_closed_form_chain_equals_the_bit_serial_chain():
    """Every (t1, t2) pair of W-bit operands under every row mask at 4 bits,
    and 200,000 random triples at 8 bits, against the reference's
    ``_chain_eval``."""
    from repro.core.operator_model import _chain_eval as ref_chain_eval

    t = np.arange(64)
    t1, t2, mask = np.meshgrid(t, t, np.arange(32), indexing="ij")
    got = chain_closed_form(torch.from_numpy(t1), torch.from_numpy(t2),
                            torch.from_numpy(mask), 4)
    want = ref_chain_eval(t1, t2, mask, 6, 5, np, np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    g = np.random.default_rng(8)
    t1, t2, mask = g.integers(0, 1024, (3, 200_000))
    got = chain_closed_form(torch.from_numpy(t1), torch.from_numpy(t2),
                            torch.from_numpy(mask), 8)
    np.testing.assert_array_equal(got.numpy(), ref_chain_eval(t1, t2, mask, 10, 9, np,
                                                              np.int64))


@pytest.mark.parametrize("n_bits", [2, 4, 6, 8])
def test_closed_form_planes_equal_the_synthesized_planes(n_bits):
    """Every row mask of the width, in every row, against ``_synth_small``."""
    from repro_torch.core.operator_model import _synth_small

    spec = spec_for(n_bits)
    masks = torch.arange(1 << spec.cols_removable, dtype=torch.int32)[:, None].repeat(
        1, spec.rows)
    want = torch.stack(_synth_small(spec, masks, torch, torch.int32))
    assert torch.equal(closed_form_planes(masks, n_bits), want)


# -- K5's nibble planes, emulated -------------------------------------------

def k5_nibble_image(small_d: torch.Tensor) -> torch.Tensor:
    """The shared-memory image of one config's nibble planes from its
    (R, 4, B) planes, as the kernel's ``synthesize_nibbles`` writes it: plane
    q at q * 16 * B, entry (nu, b) at row nu, column b ^ nu, the sum over rows
    2q, 2q + 1 of planes[r][pair_r(nu << 4q)][b] << 2(r - 2q); an odd last row
    fills 4 rows alone."""
    rows, _, nb = small_d.shape
    img = torch.zeros(((rows // 2) * 16 + (rows % 2) * 4) * nb, dtype=torch.int64)
    b = torch.arange(nb)
    for q in range((rows + 1) // 2):
        r0 = 2 * q
        two = r0 + 1 < rows
        for nu in range(16 if two else 4):
            v = small_d[r0, _pair(nu, 0)].long()
            if two:
                v = v + (small_d[r0 + 1, _pair(nu, 1)].long() << 2)
            img[(q * 16 + nu) * nb + (b ^ nu)] = v
    return img


def k5_staged_emulated(masks: torch.Tensor, a_codes: torch.Tensor, b_codes: torch.Tensor,
                       n_bits: int) -> torch.Tensor:
    """K5's redesign in plain torch: the codes packed as uint8 (A in whole
    32-row slabs, K in whole 16-code chunks, zero-padded, no padding
    subtracted), each config's nibble-plane image, per plane q the lookups at
    (q * 16 + nu) * B + (b ^ nu), nu = (a >> 4q) & 15, summed per plane and
    shifted by 4q; sums wrap modulo 2^32 as the kernel's unsigned ones."""
    small = torch.stack(_synth_small_port(n_bits, masks))       # (R, D, 4, B)
    rows, d, _, nb = small.shape
    (m, k), n = a_codes.shape, b_codes.shape[1]
    m_pad = -(-m // K4_SLAB) * K4_SLAB
    k_pad = -(-k // K4_CHUNK) * K4_CHUNK
    a8 = torch.zeros((m_pad, k_pad), dtype=torch.int64)
    a8[:m, :k] = a_codes.long() & (nb - 1)
    bt8 = torch.zeros((n, k_pad), dtype=torch.int64)
    bt8[:, :k] = (b_codes.long() & (nb - 1)).T
    av, bv = a8[:, None, :], bt8[None, :, :]                    # (M_pad, 1, K), (1, N, K)
    idx = []
    for q in range((rows + 1) // 2):
        nu = (av >> (4 * q)) & 15
        idx.append((q * 16 + nu) * nb + (bv ^ nu))
    out = torch.zeros((d, m_pad, n), dtype=torch.int64)
    for c in range(d):
        img = k5_nibble_image(small[:, c])
        for q, ix in enumerate(idx):
            out[c] += img[ix].sum(-1) << (4 * q)
    out = out[:, :m] & 0xFFFFFFFF
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _synth_small_port(n_bits, masks):
    from repro_torch.core.operator_model import _synth_small

    return _synth_small(spec_for(n_bits), masks, torch, torch.int32)


@pytest.fixture(scope="module")
def ref_fastapp():
    """The reference's device engine (imports JAX)."""
    pytest.importorskip("jax")
    from repro.apps import fastapp

    return fastapp


def _k5_configs(n_bits, n_cfgs, seed):
    spec = spec_for(n_bits)
    cfgs = np.random.default_rng(seed).integers(0, 2, (n_cfgs, spec.n_luts)).astype(np.uint8)
    return np.concatenate([cfgs, np.zeros((1, spec.n_luts), np.uint8),
                           np.ones((1, spec.n_luts), np.uint8)])


def _k5_check(ref_fastapp, n_bits, cfgs, a, b):
    """The emulation == entry_gemv_plain == the reference's entry route ==
    numpy table_matmul, exactly."""
    masks = torch.from_numpy(config_to_masks(spec_for(n_bits), cfgs).astype(np.int32))
    a_t, b_t = (torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in (a, b))
    got = k5_staged_emulated(masks, a_t, b_t, n_bits)
    assert torch.equal(got, k4.entry_gemv_plain(masks, a_t, b_t, n_bits))
    nb = 1 << n_bits
    tables = ref_product_tables(ref_spec_for(n_bits), cfgs)
    want = np.stack([ref_table_matmul(t, a & (nb - 1), b & (nb - 1)) for t in tables])
    np.testing.assert_array_equal(got.numpy(), want)
    rbatch = ref_fastapp.table_batch(ref_spec_for(n_bits), cfgs)
    np.testing.assert_array_equal(
        np.asarray(ref_fastapp.table_matmul_jax(rbatch, a & (nb - 1), b & (nb - 1),
                                                impl="entry")), want)


# the five app shapes chip_smoke.py times K5 at
K5_SHAPES = dict(APP_SHAPES, **{"ragged K": (250, 100, 10)})


@pytest.mark.parametrize("name", sorted(K5_SHAPES))
def test_k5_nibble_planes_match_plain_and_reference(ref_fastapp, name):
    """The five app shapes, 2 random configs plus the all-zeros and the
    accurate one, codes of the whole 8-bit range."""
    m, k, n = K5_SHAPES[name]
    rng = np.random.default_rng(m + k + n)
    _k5_check(ref_fastapp, 8, _k5_configs(8, 2, m), rng.integers(0, 256, (m, k)),
              rng.integers(0, 256, (k, n)))


@pytest.mark.parametrize("n_bits, m, k, n", [(8, 23, 100, 7), (8, 33, 17, 16), (8, 1, 1, 1),
                                             (4, 70, 37, 5), (6, 41, 19, 3), (2, 9, 5, 2)])
def test_k5_nibble_planes_ragged_and_narrow(ref_fastapp, n_bits, m, k, n):
    """Ragged M and K, and 4, 6 (the odd last row: a 4-entry plane) and 2
    bits, with codes out of range (taken modulo 2^n_bits)."""
    rng = np.random.default_rng(k)
    nb = 1 << n_bits
    _k5_check(ref_fastapp, n_bits, _k5_configs(n_bits, 3, m),
              rng.integers(-2 * nb, 3 * nb, (m, k)), rng.integers(0, nb, (k, n)))


@pytest.mark.parametrize("n_bits", [4, 6, 8])
def test_k5_swizzle_puts_the_sixteen_nibbles_of_a_column_in_sixteen_banks(n_bits):
    """Entry (nu, b) at row nu, column b ^ nu: for every b the 16 rows fall
    in 16 distinct banks of 4-byte words (a warp's lanes share b, so lanes
    with different nu never conflict and lanes with one nu read one word);
    the image holds every folded entry at that place."""
    nb = 1 << n_bits
    nu = torch.arange(16)
    for b in range(nb):
        banks = (nu * nb + (b ^ nu)) % 32
        assert len(set(banks.tolist())) == 16
    spec = spec_for(n_bits)
    masks = torch.from_numpy(config_to_masks(spec, _k5_configs(n_bits, 1, 3)).astype(np.int32))
    small = torch.stack(_synth_small_port(n_bits, masks))[:, 0].long()
    img = k5_nibble_image(small)
    b = torch.arange(nb)
    for n_val in range(16):
        want = small[0, _pair(n_val, 0)] + (small[1, _pair(n_val, 1)] << 2)
        assert torch.equal(img[n_val * nb + (b ^ n_val)], want)


# -- K2's walk over synthesized column values, emulated ---------------------

def entry_exact_and_weights(n_bits: int):
    """K2's exact = a_s * b_s and w = rn(1 / f32(max(|exact|, 1))), the
    operand formed as the kernel forms it (``exact_float``)."""
    nb = 1 << n_bits
    codes = torch.arange(nb)
    sv = torch.where(codes >= nb // 2, codes - nb, codes)
    exact = sv[:, None] * sv[None, :]
    w = 1.0 / exact_float(exact.abs().clamp(min=1))
    return exact.to(torch.int32), w


def k2_walk_emulated(masks, n_bits, a_tile):
    """K2's redesign: K1's walk (the same groups, base rows, half row and
    registers) over plane values computed in closed form at the thread's
    column, with the exact products and weights from the codes."""
    exact, w = entry_exact_and_weights(n_bits)
    return k1_walk_emulated(closed_form_planes(masks, n_bits), exact, w, a_tile)


def test_reciprocal_equals_f32_division_for_every_product():
    """rn(1/x), the correctly rounded reciprocal that ``__frcp_rn`` returns,
    found here with exact rationals, equals the plain version's f32 division
    1.0 / x for every |exact| in [1, 2^14], x formed by ``exact_float``."""
    from fractions import Fraction

    x = torch.arange(1, (1 << 14) + 1)
    xf = exact_float(x)
    assert torch.equal(xf, x.to(torch.float32))
    division = (1.0 / xf).numpy()
    for v, got in zip(x.tolist(), division.tolist()):
        c = np.float32(1.0 / v)
        cands = [np.nextafter(c, np.float32(0)), c, np.nextafter(c, np.float32(1))]
        errs = [abs(Fraction(float(f)) - Fraction(1, v)) for f in cands]
        best = min(errs)
        ties = [f for f, e in zip(cands, errs) if e == best]
        rn = ties[0] if len(ties) == 1 else next(
            f for f in ties if int(np.float32(f).view(np.int32)) % 2 == 0)
        assert got == float(rn), v


@pytest.mark.parametrize("n_bits", [2, 4, 6, 8])
def test_k2_walk_matches_plain_and_reference(n_bits):
    """At the default a_tile of each width and at a_tile 8 (an odd GB: the
    half row), on 9 random configs plus the accurate and the all-zeros one:
    int channels exactly, the f32 channel to 1e-5, against the plain version
    and the reference's XLA twin ``_partials_xla(source="entry")``."""
    spec = spec_for(n_bits)
    rng = np.random.default_rng(20 + n_bits)
    cfgs = np.concatenate([rng.integers(0, 2, (9, spec.n_luts)).astype(np.uint8),
                           np.ones((1, spec.n_luts), np.uint8),
                           np.zeros((1, spec.n_luts), np.uint8)])
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32))
    tiles = {fastchar.default_a_tile(spec), min(8, 1 << n_bits)}
    for a_tile in sorted(tiles):
        got_i, got_r = k2_walk_emulated(masks, n_bits, a_tile)
        want_i, want_r = k1.behav_stats_entry_plain(masks, n_bits, a_tile)
        assert torch.equal(got_i, want_i), a_tile
        torch.testing.assert_close(got_r, want_r, rtol=1e-5, atol=0)
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import fastchar as ref_fastchar

    for a_tile in sorted(tiles):
        ref_i, ref_r = ref_fastchar._partials_xla(jnp.asarray(masks.numpy()), n_bits, a_tile,
                                                  len(cfgs), source="entry")
        got_i, got_r = k2_walk_emulated(masks, n_bits, a_tile)
        np.testing.assert_array_equal(np.asarray(ref_i), got_i.numpy())
        np.testing.assert_allclose(np.asarray(ref_r), got_r.numpy(), rtol=1e-5)
