"""Kernel registry: one spec per implementation on each engine's menu.

Counterpart of ``repro/kernels/registry.py``.  Every implementation an engine
can run registers here as ``<engine>.<impl>``, named after the engine menus
of ``core.engine`` (which reads them from here):

  * its **tunable space** -- ordered ``(param, candidates)`` pairs, and only
    launch parameters the kernel's wrapper takes at run time (K1's
    ``a_tile``, K2's ``a_tile`` and configs a thread, K4's route and gather
    tiles, K6's K splits); tiles that are template arguments of a ``.cu``
    file are not tunables, and a spec with none has an empty space;
  * its **defaults** -- exactly the choice the engines make untuned
    (``core.fastchar.default_a_tile``, ``char_kernels.entry_configs``,
    ``app_kernels.plan``, ``axo_matmul.plan``), so ``tuning="off"`` is the
    untuned path bit for bit;
  * a **constraint** on candidates: the int32-safety bound of the BEHAV
    partials and Hopper's limits (:data:`HOPPER`, the SM count from the
    device);
  * a **cost formula** -- the reference's counts of FLOPs (or integer ops),
    bytes accessed and transcendentals for the same function, so that the
    count does not change with the design that computes it (K8, which the
    reference does not register, counts its plain version's algebra);
  * the **wrapper** and its **oracle**, the plain version, as lazy
    ``"module:attr"`` references;
  * the reference's power-of-two **shape bucket**, the tuning cache's key.

Defaults and constraints take the exact shape (the reference's take the
bucket): the port's launch planners are functions of the exact shape, and
"off" must reproduce them.  The reference's compiler-params formulas have no
counterpart.

The module is pure data: importing it pulls in neither torch nor a kernel
module; shapes are keyword arguments (``n_bits, d`` for fastchar; ``n_bits,
d, m, k, n`` for fastapp; ``m, k, n, rank`` for axo_matmul; ``b, h, g, sq,
skv, hd, causal`` for attention; ``b, s, h, g, p, n, chunk`` for ssd_scan;
``p, n_obj`` for fastmoo).  Engines resolve tiles through
:func:`repro_torch.kernels.tuning.tiles_for`.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, NamedTuple

__all__ = [
    "KernelSpec",
    "HOPPER",
    "sm_count",
    "register",
    "get",
    "specs_for",
    "impl_names",
    "registered",
    "describe",
    "ENGINES",
]

ENGINES = ("fastchar", "fastmoo", "fastapp", "axo_matmul", "attention", "ssd_scan")


class HopperLimits(NamedTuple):
    """Hopper's limits for the constraints.  The run-time tunables move shared
    memory (K4's gather tiles, K6's plan) and the grid (K2, K6), never a
    kernel's registers: those are fixed by its ``.cu`` build, whose
    ``-Xptxas -v`` report ``chip_smoke.py`` prints."""

    max_smem: int          # dynamic shared memory one block may use, bytes
    max_regs_thread: int   # registers a thread
    max_regs_sm: int       # registers an SM
    sms: int               # SMs of an H100 SXM, where no card answers


HOPPER = HopperLimits(max_smem=227 * 1024, max_regs_thread=255, max_regs_sm=64 * 1024, sms=132)


def sm_count() -> int:
    """The current card's SM count, or :data:`HOPPER`'s where no card answers."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_available():
        return _device_sms(torch.cuda.current_device())
    return HOPPER.sms


_SMS: dict = {}


def _device_sms(index: int) -> int:
    if index not in _SMS:
        import torch

        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _pow2_bucket(x: int, cap: int = 1 << 14) -> int:
    """Smallest power of two >= x (>= 1), capped -- the shape-bucket rule."""
    x = max(int(x), 1)
    b = 1
    while b < x and b < cap:
        b <<= 1
    return b


def _resolve_ref(ref: str):
    mod, attr = ref.split(":")
    return getattr(importlib.import_module(mod), attr)


@dataclass(frozen=True)
class KernelSpec:
    """One registered implementation.

    ``fn_ref`` is the wrapper the engine calls and ``oracle_ref`` its plain
    version, both lazy ``"module:attr"`` references (``None`` where the
    implementation is itself a plain version).  ``tunables`` is the ordered
    tile space; ``defaults_fn(**shape)`` the untuned tiles;
    ``constraint(shape, tiles)`` filters candidates; ``cost_fn(**shape)``
    returns ``{"flops", "bytes_accessed", "transcendentals"}``; ``tol`` is
    the f32 parity tolerance of a tuned candidate against the oracle;
    ``peak_type`` names the ``launch.roofline.HW`` rate its counted operations
    run at on the card (``"f32"``: the CUDA cores; ``"tf32"``, ``"bf16"``:
    tensor cores).
    """

    name: str                                   # "fastchar.table", ...
    engine: str                                 # one of ENGINES
    impl: str                                   # the menu name
    fn_ref: str | None = None
    oracle_ref: str | None = None
    tunables: tuple = ()                        # ((param, (candidates...)), ...)
    defaults_fn: Callable | None = None         # (**shape) -> {param: value}
    bucket_fn: Callable | None = None           # (**shape) -> hashable bucket
    constraint: Callable | None = None          # (shape, tiles) -> bool
    cost_fn: Callable | None = None             # (**shape) -> dict
    tol: float = 1e-6
    peak_type: str = "f32"                      # the roofline rate its operations run at
    description: str = ""

    @property
    def fn(self):
        return None if self.fn_ref is None else _resolve_ref(self.fn_ref)

    @property
    def oracle(self):
        return None if self.oracle_ref is None else _resolve_ref(self.oracle_ref)

    def bucket(self, **shape) -> tuple:
        """Shape bucket of ``shape``: the tuning cache's key component."""
        return () if self.bucket_fn is None else tuple(self.bucket_fn(**shape))

    def default_tiles(self, **shape) -> dict:
        """The untuned tiles at ``shape``."""
        return dict(self.defaults_fn(**shape)) if self.defaults_fn else {}

    def candidates(self, **shape) -> list[dict]:
        """Every admissible tile assignment at ``shape`` (full product)."""
        combos: list[dict] = [{}] if self.tunables else []
        for param, values in self.tunables:
            combos = [{**c, param: v} for c in combos for v in values]
        if self.constraint is not None:
            combos = [c for c in combos if self.constraint(shape, c)]
        return combos

    def cost_estimate(self, **shape) -> dict | None:
        return None if self.cost_fn is None else self.cost_fn(**shape)


_REGISTRY: dict[str, KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    if spec.engine not in ENGINES:
        raise ValueError(f"unknown engine {spec.engine!r} (not in {ENGINES})")
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel {name!r} registered (have {sorted(_REGISTRY)})") from None


def registered() -> tuple[KernelSpec, ...]:
    return tuple(_REGISTRY.values())


def specs_for(engine: str) -> tuple[KernelSpec, ...]:
    return tuple(s for s in _REGISTRY.values() if s.engine == engine)


def impl_names(engine: str) -> tuple[str, ...]:
    """The engine's menu, in registration order."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (not in {ENGINES})")
    return tuple(s.impl for s in _REGISTRY.values() if s.engine == engine)


def describe() -> str:
    """Human-readable listing of every spec and its tile space."""
    lines = []
    for engine in ENGINES:
        lines.append(f"{engine}:")
        for s in specs_for(engine):
            space = ", ".join(f"{p} in {list(v)}" for p, v in s.tunables) or "no tunables"
            lines.append(f"  {s.impl:12s} {s.name:22s} {space}")
            if s.description:
                lines.append(f"               {s.description}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# fastchar: BEHAV partials (K1, K2)
# ---------------------------------------------------------------------------


def _char_bucket(*, n_bits: int, d: int, **_):
    return (int(n_bits), _pow2_bucket(d, cap=1024))


def _char_spec(shape):
    from ..core.operator_model import spec_for

    return spec_for(shape["n_bits"], signed=shape.get("signed", True))


def _char_constraint(shape, tiles) -> bool:
    """a_tile divides A and keeps every int32 tile partial below 2^31: a
    tile's a_tile x B pairs each add at most max|e| (sum|e|, hi*hi, hi*lo)
    or 255^2 (lo*lo) to a channel."""
    from ..core.fastchar import max_abs_error_bound

    a = 1 << shape["n_bits"]
    a_tile = tiles["a_tile"]
    if a_tile > a or a % a_tile:
        return False
    bound = max_abs_error_bound(_char_spec(shape))
    return a_tile * a * max(bound, min(bound, 255) ** 2) < (1 << 31)


def _char_defaults(**shape) -> dict:
    from ..core.fastchar import default_a_tile

    return {"a_tile": default_a_tile(_char_spec(shape))}


def entry_configs(d: int, n_bits: int, a_tile: int, n_sms: int) -> int:
    """K2's configs a thread (``kernels.char_kernels.entry_configs``): 4 where
    a grid of 4-config threads (256 / B sub-blocks of B threads a block, by
    B / a_tile A-tiles) still has a block for each of ``n_sms`` SMs, else 1."""
    blocks = -(-d // ((256 >> n_bits) * 4)) * ((1 << n_bits) // a_tile)
    return 4 if blocks >= n_sms else 1


def _entry_char_defaults(**shape) -> dict:
    a_tile = _char_defaults(**shape)["a_tile"]
    return {"a_tile": a_tile,
            "configs": entry_configs(shape["d"], shape["n_bits"], a_tile, sm_count())}


def _char_cost(*, rows: int, d: int, a: int, b: int, a_tile: int, **_) -> dict:
    # per element of the (D, A, B) error table: R plane-selects + shift-adds,
    # the |e| decomposition and 6 reduction channels; outputs are the two
    # (A/a_tile, D, 8) partial stacks
    return {
        "flops": d * a * b * (6 * rows + 12),
        "bytes_accessed": 4 * (rows * d * 4 * b + 2 * a * b) + 8 * (a // a_tile) * d * 8,
        "transcendentals": 0,
    }


def _entry_char_cost(*, rows: int, d: int, a: int, b: int, a_tile: int,
                     width: int, **_) -> dict:
    # the table kernel's reduction plus the synthesis: R*4 carry chains of
    # `width` steps (~6 ops each) over the B axis, re-run per A tile; the
    # bytes are the (D, R) masks and the partial stacks
    return {
        "flops": d * a * b * (6 * rows + 12) + (a // a_tile) * d * rows * 4 * b * width * 6,
        "bytes_accessed": 4 * d * rows + 8 * (a // a_tile) * d * 8,
        "transcendentals": 0,
    }


_A_TILES = (8, 16, 32, 64, 128, 256)

register(KernelSpec(
    name="fastchar.table", engine="fastchar", impl="table",
    fn_ref="repro_torch.kernels.char_kernels:behav_stats_table",
    oracle_ref="repro_torch.kernels.char_kernels:behav_stats_table_plain",
    tunables=(("a_tile", _A_TILES),),
    defaults_fn=_char_defaults, bucket_fn=_char_bucket, constraint=_char_constraint,
    cost_fn=_char_cost,
    description="K1: per-A-tile BEHAV partials from gathered row planes (register walk)",
))

register(KernelSpec(
    name="fastchar.entry", engine="fastchar", impl="entry",
    fn_ref="repro_torch.kernels.char_kernels:behav_stats_entry",
    oracle_ref="repro_torch.kernels.char_kernels:behav_stats_entry_plain",
    tunables=(("a_tile", _A_TILES), ("configs", (4, 1))),
    defaults_fn=_entry_char_defaults, bucket_fn=_char_bucket, constraint=_char_constraint,
    cost_fn=_entry_char_cost,
    description="K2: the walk over plane values in closed form from the masks",
))

register(KernelSpec(
    name="fastchar.plain", engine="fastchar", impl="plain",
    fn_ref="repro_torch.kernels.char_kernels:behav_stats_table_plain",
    bucket_fn=_char_bucket, cost_fn=_char_cost,
    description="K1's plain version: the reference's _partials_xla tiling in torch",
))

# ---------------------------------------------------------------------------
# fastmoo: constraint-dominated ranking (K3)
# ---------------------------------------------------------------------------


def _moo_bucket(*, p: int, n_obj: int = 2, **_):
    return (_pow2_bucket(p), int(n_obj))


def _moo_cost(*, p: int, n_obj: int = 2, **_) -> dict:
    return {
        "flops": p * p * (4 * n_obj + 8),
        "bytes_accessed": 4 * (2 * p * n_obj + 4 * p),
        "transcendentals": 0,
    }


register(KernelSpec(
    name="fastmoo.kernel", engine="fastmoo", impl="kernel",
    fn_ref="repro_torch.kernels.moo_kernels:constraint_fronts",
    oracle_ref="repro_torch.kernels.moo_kernels:constraint_fronts_plain",
    bucket_fn=_moo_bucket, cost_fn=_moo_cost,
    description="K3: every feasible front peeled in one block a ranking",
))

register(KernelSpec(
    name="fastmoo.plain", engine="fastmoo", impl="plain",
    fn_ref="repro_torch.kernels.moo_kernels:constraint_fronts_plain",
    bucket_fn=_moo_bucket, cost_fn=_moo_cost,
    description="K3's plain version: the (P, P) dominance matrix, peeled a round at a time",
))

# ---------------------------------------------------------------------------
# fastapp: table arithmetic (K4, K5)
# ---------------------------------------------------------------------------

def _app_bucket(*, n_bits: int, d: int, m: int, k: int, n: int, **_):
    return (int(n_bits), _pow2_bucket(d, cap=1024), _pow2_bucket(m), _pow2_bucket(k),
            _pow2_bucket(n))


def _k4_plan(shape, route=None):
    from .app_kernels import plan

    return plan(shape["m"], shape["k"], shape["n"], shape["n_bits"], route)


def _app_defaults(*, n_bits: int, m: int, k: int, n: int, **_) -> dict:
    pl = _k4_plan(dict(n_bits=n_bits, m=m, k=k, n=n))
    return {"route": pl.route, "m_tile": pl.m_tile, "k_tile": pl.k_tile}


def _app_constraint(shape, tiles) -> bool:
    """The staged route where its layout fits (no gather tiles); the gather
    route at tiles within the problem and its shared-memory budget."""
    route, m_tile, k_tile = tiles["route"], tiles["m_tile"], tiles["k_tile"]
    if route == "staged":
        if m_tile or k_tile:
            return False
        try:
            _k4_plan(shape, "staged")
        except ValueError:
            return False
        return True
    m, k, n = shape["m"], shape["k"], shape["n"]
    if m_tile < 1 or k_tile < 1 or m_tile > max(m, 8) or k_tile > max(k, 16):
        return False
    from .app_kernels import SMEM_BUDGET

    smem = (m_tile * (k_tile + 1) + k_tile * n) * 4
    return smem <= SMEM_BUDGET <= HOPPER.max_smem


def _app_cost(*, d: int, m: int, k: int, n: int, n_bits: int, **_) -> dict:
    a = 1 << n_bits
    return {
        "flops": 2 * d * m * k * n,
        "bytes_accessed": 4 * (d * a * a + m * k + k * n + d * m * n),
        "transcendentals": 0,
    }


def _entry_app_cost(*, d: int, m: int, k: int, n: int, n_bits: int, **_) -> dict:
    # R gather-accumulate passes over the (M, K, N) tensor + the per-grid-step
    # synthesis (R*4 chains of `width` steps over the B axis; one grid step
    # per default-width K tile of 64)
    a, rows, width = 1 << n_bits, n_bits // 2, n_bits + 2
    return {
        "flops": 2 * d * m * k * n * rows + d * max(1, k // 64) * rows * 4 * a * width * 6,
        "bytes_accessed": 4 * (d * rows + m * k + k * n + d * m * n),
        "transcendentals": 0,
    }


register(KernelSpec(
    name="fastapp.table", engine="fastapp", impl="table",
    fn_ref="repro_torch.kernels.app_kernels:table_gemv",
    oracle_ref="repro_torch.kernels.app_kernels:table_gemv_plain",
    tunables=(("route", ("staged", "gather")), ("m_tile", (0, 8, 16, 32)),
              ("k_tile", (0, 16, 32, 64, 128, 256))),
    defaults_fn=_app_defaults, bucket_fn=_app_bucket, constraint=_app_constraint,
    cost_fn=_app_cost,
    description="K4: table GEMV, a config's table staged in shared memory or gathered",
))

register(KernelSpec(
    name="fastapp.entry", engine="fastapp", impl="entry",
    fn_ref="repro_torch.kernels.app_kernels:entry_gemv",
    oracle_ref="repro_torch.kernels.app_kernels:entry_gemv_plain",
    bucket_fn=_app_bucket, cost_fn=_entry_app_cost,
    description="K5: nibble planes built from the masks (its launcher splits the slabs)",
))

register(KernelSpec(
    name="fastapp.gemm", engine="fastapp", impl="gemm",
    bucket_fn=_app_bucket, cost_fn=_app_cost,
    description="pair-plane masked f32 GEMMs over the per-row tables",
))

register(KernelSpec(
    name="fastapp.entry_gather", engine="fastapp", impl="entry_gather",
    fn_ref="repro_torch.kernels.app_kernels:planes_gemv_plain",
    bucket_fn=_app_bucket, cost_fn=_entry_app_cost,
    description="K5's plain version: gathers from the synthesized planes",
))

register(KernelSpec(
    name="fastapp.plain", engine="fastapp", impl="plain",
    fn_ref="repro_torch.kernels.app_kernels:table_gemv_plain",
    bucket_fn=_app_bucket, cost_fn=_app_cost,
    description="K4's plain version: flattened gathers from the product tables",
))

# ---------------------------------------------------------------------------
# axo_matmul: the AxO serving matmul (K6)
# ---------------------------------------------------------------------------


def _axo_bucket(*, m: int, k: int, n: int, rank: int, **_):
    return (_pow2_bucket(m), _pow2_bucket(k), _pow2_bucket(n), _pow2_bucket(rank, cap=64))


def _k6_plan(shape, splits=None):
    from .axo_matmul import plan

    return plan(shape["m"], shape["n"], shape["k"], shape["rank"],
                shape.get("n_codes", 256), sm_count(), splits)


def _axo_defaults(**shape) -> dict:
    return {"splits": _k6_plan(shape).splits}


def _axo_constraint(shape, tiles) -> bool:
    """A split count the shape's route takes (the small-M route's and the
    GEMV's up to 64, the skinny route's up to 32, route 1's up to 16) and
    that splits K into that many whole k-steps (not fewer after rounding),
    within shared memory."""
    try:
        pl = _k6_plan(shape, tiles["splits"])
    except ValueError:
        return False
    return pl.splits == tiles["splits"] and pl.smem <= HOPPER.max_smem


def _axo_cost(*, m: int, k: int, n: int, rank: int, **_) -> dict:
    return {
        # the exact product plus one matmul per rank term
        "flops": 2 * m * n * k * (1 + rank),
        "bytes_accessed": 4 * ((1 + rank) * (m * k + k * n) + m * n),
        "transcendentals": 0,
    }


register(KernelSpec(
    name="axo_matmul.kernel", engine="axo_matmul", impl="kernel",
    fn_ref="repro_torch.kernels.axo_matmul:axo_matmul",
    oracle_ref="repro_torch.kernels.axo_matmul:axo_matmul_plain",
    tunables=(("splits", (1, 2, 4, 8, 16, 32, 64)),),
    defaults_fn=_axo_defaults, bucket_fn=_axo_bucket, constraint=_axo_constraint,
    cost_fn=_axo_cost, tol=1e-5,
    peak_type="tf32",
    description="K6: small-M TF32 tensor cores (M <= 16 at rank 8: the activation "
                "rows on the MMA's 8-wide side, each weight code expanded once; the "
                "f32 GEMV elsewhere), skinny TF32 tensor cores (M <= 80: the "
                "weight's columns on the MMA's 16-row side, 24- or 80-row blocks), "
                "wgmma TF32 on planes expanded once a block (M >= 512) or 128 x 128 "
                "mma.sync TF32 tiles, split along K",
))

register(KernelSpec(
    name="axo_matmul.plain", engine="axo_matmul", impl="plain",
    fn_ref="repro_torch.kernels.axo_matmul:axo_matmul_plain",
    bucket_fn=_axo_bucket, cost_fn=_axo_cost, tol=1e-5,
    peak_type="tf32",
    description="K6's plain version: gathers, then f32 matmuls",
))

# ---------------------------------------------------------------------------
# attention: prefill attention (K7)
# ---------------------------------------------------------------------------


def _flash_bucket(*, sq: int, skv: int, hd: int, **_):
    return (_pow2_bucket(sq), _pow2_bucket(skv), _pow2_bucket(hd, cap=256))


def _flash_cost(*, b: int, h: int, sq: int, skv: int, hd: int, causal: bool = True,
                **_) -> dict:
    pairs = b * h * sq * skv // (2 if causal else 1)
    return {
        "flops": 4 * pairs * hd,  # q k^T and p v, 2 flops a MAC each
        "bytes_accessed": 4 * (2 * b * h * sq * hd + 2 * b * h * skv * hd),
        "transcendentals": pairs,  # one exp per unmasked score
    }


register(KernelSpec(
    name="attention.kernel", engine="attention", impl="kernel",
    fn_ref="repro_torch.kernels.flash_attention:flash_attention",
    oracle_ref="repro_torch.kernels.flash_attention:flash_attention_plain",
    bucket_fn=_flash_bucket, cost_fn=_flash_cost, tol=5e-6,
    peak_type="bf16",
    description="K7: online-softmax GQA attention: mma.sync over 64 x 64 tiles (short "
                "causal prefills at hd <= 64), wgmma on 64/128/192 query rows against "
                "TMA-fed 128-key tiles (non-causal and long causal calls) or on a KV "
                "group's heads at the same 64 rows (short causal prefills at hd 112/128); "
                "tiles are fixed by the route",
))

register(KernelSpec(
    name="attention.plain", engine="attention", impl="plain",
    fn_ref="repro_torch.kernels.flash_attention:flash_attention_plain",
    bucket_fn=_flash_bucket, cost_fn=_flash_cost, tol=5e-6,
    peak_type="bf16",
    description="K7's plain version: the direct masked softmax",
))

# ---------------------------------------------------------------------------
# ssd_scan: the Mamba-2 prefill scan (K8).  The reference registers no scan;
# K8 is here, with an empty tile space, so that every kernel of the port has
# its cost formula in one place.
# ---------------------------------------------------------------------------


def _ssd_bucket(*, b: int, s: int, h: int, p: int, n: int, **_):
    return (_pow2_bucket(b), _pow2_bucket(s), _pow2_bucket(h), _pow2_bucket(p),
            _pow2_bucket(n))


def _ssd_cost(*, b: int, s: int, h: int, g: int, p: int, n: int, chunk: int = 128,
              **_) -> dict:
    """The plain version's chunked algebra at chunk length ``chunk``: the
    intra-chunk scores C B^T (per group) and their product with x (per head)
    over every (position, earlier position in its chunk) pair, each chunk's
    state B^T x and the cross-chunk C . state (per head); the bytes read x,
    dt, a, B, C once and write y and the f32 final state once; one exp a
    (position, head) decay and one a pair's segment sum."""
    q = min(chunk, s)
    pairs = sum(c * (c + 1) // 2 for c in (min(q, s - t) for t in range(0, s, q)))
    return {
        "flops": 2 * b * g * n * pairs + 2 * b * h * p * pairs + 4 * b * h * s * n * p,
        "bytes_accessed": 4 * (2 * b * s * h * p + 2 * b * s * g * n + b * s * h + h
                               + b * h * p * n),
        "transcendentals": b * h * (s + pairs),
    }


register(KernelSpec(
    name="ssd_scan.kernel", engine="ssd_scan", impl="kernel",
    fn_ref="repro_torch.kernels.ssd_scan:ssd_scan",
    oracle_ref="repro_torch.kernels.ssd_scan:ssd_scan_plain",
    bucket_fn=_ssd_bucket, cost_fn=_ssd_cost,
    peak_type="bf16",
    description="K8: the chunked scan, tensor-core route in bf16 (route by dtype)",
))

register(KernelSpec(
    name="ssd_scan.plain", engine="ssd_scan", impl="plain",
    fn_ref="repro_torch.kernels.ssd_scan:ssd_scan_plain",
    bucket_fn=_ssd_bucket, cost_fn=_ssd_cost,
    peak_type="bf16",
    description="K8's plain version: the chunked SSD algebra in torch",
))
