"""The port's kernel registry against the reference's and the engines' choices.

Counterpart of ``tests/test_registry.py``.  Every engine has its menu; names
are checked; each spec's defaults are exactly the choice the engines make
untuned (``fastchar.default_a_tile``, ``char_kernels.entry_configs``,
``app_kernels.plan``, ``axo_matmul.plan``) at the main path's, the apps' and
the serving shapes, so ``tuning="off"`` is the untuned path; every K1 and K2
tile candidate's plain version equals the reference's XLA twin
``fastchar._partials_xla`` at the same ``a_tile`` (int channels bit for bit,
the f32 channel to 1e-5 relative, as the port's characterization tests hold
it: f32 sums in another order), and every K4 and K5 candidate the reference's
numpy ``table_matmul`` bit for bit; each ``cost_fn`` equals the reference's
formula at the same shape.  On the CPU the wrappers run their plain
versions, so a candidate's tiles are checked by the wrapper's planner and
its outputs by the plain version.
"""

import numpy as np
import pytest
import torch

from repro.apps.base import table_matmul as ref_table_matmul
from repro.core.operator_model import product_tables as ref_product_tables
from repro.core.operator_model import spec_for as ref_spec_for
from repro.kernels import registry as ref_registry

from repro_torch.core import fastchar
from repro_torch.core.engine import ENGINE_MENUS, ExecutionContext
from repro_torch.core.operator_model import config_to_masks, spec_for
from repro_torch.kernels import app_kernels, axo_matmul, char_kernels, registry

CPU = ExecutionContext(device="cpu")
H100_SMS = 132

# main path: the training set's 1024-config chunks and its ragged tail, a
# front, one config
CHAR_SHAPES = [dict(n_bits=8, d=d) for d in (1024, 212, 37, 1)] + [dict(n_bits=4, d=80)]
# the apps' K4/K5 shapes (chip_smoke.py phase 3): mnist head, ffn GEMM1, a
# ragged K, the ecg and gauss convolutions
APP_SHAPES = [(250, 256, 10), (96, 64, 128), (250, 100, 10), (2034, 15, 1), (8464, 25, 1)]
# K6 at the serving shapes: granite decode and prefill, its head, kimi-k2's
# expert buffers, deepseek-v3's 24-row buffer, whisper's cross K/V
K6_SHAPES = [(4, 2048, 2048), (4, 2048, 8192), (4, 8192, 2048), (512, 2048, 8192),
             (4, 2048, 49155), (16, 7168, 2048), (8, 2048, 7168), (24, 7168, 2048),
             (6000, 1024, 1024)]


@pytest.fixture(scope="module")
def ref_fastchar():
    """The reference's XLA engine (imports JAX, which the card's host lacks)."""
    pytest.importorskip("jax")
    from repro.core import fastchar as ref

    return ref


def test_every_engine_has_its_menu():
    assert registry.ENGINES == tuple(ENGINE_MENUS)
    for engine in registry.ENGINES:
        menu = registry.impl_names(engine)
        assert menu and menu == ENGINE_MENUS[engine]
        assert [s.name for s in registry.specs_for(engine)] == [f"{engine}.{i}" for i in menu]
    assert ENGINE_MENUS["fastchar"] == ("table", "entry", "plain")
    assert ENGINE_MENUS["fastapp"] == ("table", "entry", "gemm", "entry_gather", "plain")
    assert all(ENGINE_MENUS[e] == ("kernel", "plain")
               for e in ("fastmoo", "axo_matmul", "attention", "ssd_scan"))
    # every spec's wrapper and plain version resolve
    for spec in registry.registered():
        assert spec.fn_ref is None or callable(spec.fn)
        assert spec.oracle_ref is None or callable(spec.oracle)


def test_unknown_and_duplicate_names_raise():
    with pytest.raises(KeyError, match="no kernel"):
        registry.get("fastchar.pallas")
    with pytest.raises(ValueError, match="already registered"):
        registry.register(registry.get("axo_matmul.kernel"))
    with pytest.raises(ValueError, match="unknown engine"):
        registry.register(registry.KernelSpec(name="x.y", engine="x", impl="y"))
    with pytest.raises(ValueError, match="unknown engine"):
        registry.impl_names("flash_attention")
    with pytest.raises(ValueError, match="tuning"):
        ExecutionContext(device="cpu", tuning="always")


def test_describe_lists_every_spec():
    text = registry.describe()
    for spec in registry.registered():
        assert spec.name in text
    assert "no tunables" in text   # K3, K5, K7, K8 and the plain versions


@pytest.mark.parametrize("shape", CHAR_SHAPES, ids=lambda s: f"{s['n_bits']}b-d{s['d']}")
def test_fastchar_defaults_are_the_untuned_choice(shape):
    spec = spec_for(shape["n_bits"])
    a_tile = fastchar.default_a_tile(spec)
    assert registry.get("fastchar.table").default_tiles(**shape) == {"a_tile": a_tile}
    assert registry.get("fastchar.plain").default_tiles(**shape) == {}
    assert registry.get("fastchar.entry").default_tiles(**shape) == {
        "a_tile": a_tile,
        "configs": char_kernels.entry_configs(shape["d"], shape["n_bits"], a_tile, H100_SMS)}
    # an unsigned multiplier's bound is larger: its a-tile is fastchar's too
    unsigned = spec_for(shape["n_bits"], signed=False)
    assert registry.get("fastchar.table").default_tiles(**shape, signed=False) == {
        "a_tile": fastchar.default_a_tile(unsigned)}


@pytest.mark.parametrize("mkn", APP_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fastapp_defaults_are_the_untuned_plan(mkn):
    m, k, n = mkn
    pl = app_kernels.plan(m, k, n, 8)
    tiles = registry.get("fastapp.table").default_tiles(n_bits=8, d=128, m=m, k=k, n=n)
    assert tiles == {"route": pl.route, "m_tile": pl.m_tile, "k_tile": pl.k_tile}
    assert app_kernels.plan(m, k, n, 8, tiles["route"], tiles["m_tile"] or None,
                            tiles["k_tile"] or None) == pl
    assert registry.get("fastapp.entry").default_tiles(n_bits=8, d=128, m=m, k=k, n=n) == {}


@pytest.mark.parametrize("mkn", K6_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_axo_defaults_are_the_untuned_plan(mkn):
    m, k, n = mkn
    pl = axo_matmul.plan(m, n, k, 8, 256, H100_SMS)
    tiles = registry.get("axo_matmul.kernel").default_tiles(m=m, k=k, n=n, rank=8)
    assert tiles == {"splits": pl.splits}
    # naming the default split count plans the same launch
    assert axo_matmul.plan(m, n, k, 8, 256, H100_SMS, tiles["splits"]) == pl
    cands = registry.get("axo_matmul.kernel").candidates(m=m, k=k, n=n, rank=8)
    assert cands and all(axo_matmul.plan(m, n, k, 8, 256, H100_SMS, c["splits"]).splits
                         == c["splits"] for c in cands)


def test_char_candidates_respect_the_int32_bound():
    spec = registry.get("fastchar.table")
    for n_bits in (4, 6, 8):
        b = 1 << n_bits
        bound = fastchar.max_abs_error_bound(spec_for(n_bits))
        cands = spec.candidates(n_bits=n_bits, d=64)
        assert cands, n_bits
        for c in cands:
            assert b % c["a_tile"] == 0
            assert c["a_tile"] * b * max(bound, min(bound, 255) ** 2) < 2**31
    # 8 bits: a 256-row tile could overflow the lo^2 channel
    assert [c["a_tile"] for c in spec.candidates(n_bits=8, d=64)] == [8, 16, 32, 64, 128]
    assert len(registry.get("fastchar.entry").candidates(n_bits=8, d=64)) == 10


def test_hopper_limits_and_sm_count():
    assert registry.HOPPER.max_smem == 227 * 1024
    assert registry.HOPPER.max_regs_thread == 255
    assert registry.HOPPER.max_regs_sm == 64 * 1024
    expect = (torch.cuda.get_device_properties(0).multi_processor_count
              if torch.cuda.is_available() else H100_SMS)
    assert registry.sm_count() == expect
    # a K4 gather tile over the shared-memory budget is not admitted
    cands = registry.get("fastapp.table").candidates(n_bits=8, d=4, m=64, k=256, n=128)
    assert all((c["m_tile"] * (c["k_tile"] + 1) + c["k_tile"] * 128) * 4 <= 64 * 1024
               for c in cands if c["route"] == "gather")


def _char_configs(n_bits, d, seed):
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 2, (d, spec_for(n_bits).n_luts)).astype(np.uint8)
    cfgs[0] = 0
    cfgs[-1] = 1
    return cfgs


@pytest.mark.parametrize("source", ["table", "entry"])
@pytest.mark.parametrize("a_tile", [8, 16, 32, 64, 128])
def test_every_char_candidate_matches_the_reference_xla_twin(ref_fastchar, source, a_tile):
    import jax.numpy as jnp

    name = "fastchar.table" if source == "table" else "fastchar.entry"
    cands = [c for c in registry.get(name).candidates(n_bits=8, d=16) if c["a_tile"] == a_tile]
    assert cands
    masks = config_to_masks(spec_for(8), _char_configs(8, 16, a_tile)).astype(np.int32)
    want_i, want_r = ref_fastchar._partials_xla(jnp.asarray(masks), 8, a_tile, len(masks),
                                                source=source)
    t = torch.from_numpy(masks)
    for c in cands:
        if source == "entry":
            got_i, got_r = char_kernels.behav_stats_entry(t, 8, c["a_tile"], c["configs"])
        else:
            _, exact, w = fastchar._device_tables(8, "cpu")
            got_i, got_r = char_kernels.behav_stats_table(fastchar._gather_small(t, 8), exact,
                                                          w, c["a_tile"])
        np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy(), err_msg=str(c))
        np.testing.assert_allclose(np.asarray(want_r), got_r.numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["fastapp.table", "fastapp.entry"])
def test_every_app_candidate_matches_the_reference_numpy_table_matmul(name):
    from repro_torch.apps.fastapp import table_batch

    n_bits, d, m, k, n = 8, 3, 40, 72, 6
    cfgs = _char_configs(n_bits, d, 7)
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (m, k)).astype(np.int32)
    b = rng.integers(0, 256, (k, n)).astype(np.int32)
    want = np.stack([ref_table_matmul(t, a, b)
                     for t in ref_product_tables(ref_spec_for(n_bits), cfgs)])
    batch = table_batch(spec_for(n_bits), cfgs, CPU)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    spec = registry.get(name)
    cands = spec.candidates(n_bits=n_bits, d=d, m=m, k=k, n=n) or [
        spec.default_tiles(n_bits=n_bits, d=d, m=m, k=k, n=n)]
    if name == "fastapp.table":
        routes = {c["route"] for c in cands}
        assert routes == {"staged", "gather"} and len(cands) > 4
    for c in cands:
        if name == "fastapp.table":
            got = app_kernels.table_gemv(batch.tables.reshape(d, -1), at, bt, c["route"],
                                         c["m_tile"] or None, c["k_tile"] or None)
        else:
            got = app_kernels.entry_gemv(batch.masks, at, bt, n_bits)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(c))


COSTS = {
    "fastchar.table": (dict(rows=4, d=37, a=256, b=256, a_tile=64, width=10, n_bits=8),
                       "_char_cost"),
    "fastchar.entry": (dict(rows=4, d=37, a=256, b=256, a_tile=64, width=10, n_bits=8),
                       "_entry_char_cost"),
    "fastapp.table": (dict(d=128, m=250, k=256, n=10, n_bits=8, a=256), "_app_cost"),
    "fastapp.entry": (dict(d=128, m=250, k=256, n=10, n_bits=8, a=256, rows=4, width=10),
                      "_entry_app_cost"),
    "axo_matmul.kernel": (dict(m=512, k=2048, n=8192, rank=8), "_axo_cost"),
    "attention.kernel": (dict(b=4, h=32, g=8, sq=128, skv=128, hd=64, causal=True),
                         "_flash_cost"),
    "fastmoo.kernel": (dict(p=128, n_obj=2), "_moo_cost"),
}


@pytest.mark.parametrize("name", sorted(COSTS))
def test_cost_fn_equals_the_reference_formula(name):
    shape, ref_fn = COSTS[name]
    got = registry.get(name).cost_estimate(**shape)
    assert got == getattr(ref_registry, ref_fn)(**shape)
    assert set(got) == {"flops", "bytes_accessed", "transcendentals"}


def test_ssd_cost_counts_the_plain_algebra():
    """K8 (no reference spec): at one chunk the pair count is S(S+1)/2."""
    got = registry.get("ssd_scan.kernel").cost_estimate(b=2, s=64, h=4, g=1, p=16, n=8,
                                                        chunk=64)
    pairs = 64 * 65 // 2
    assert got["flops"] == 2 * 2 * 1 * 8 * pairs + 2 * 2 * 4 * 16 * pairs + 4 * 2 * 4 * 64 * 8 * 16
    assert got["bytes_accessed"] == 4 * (2 * 2 * 64 * 4 * 16 + 2 * 2 * 64 * 8 + 2 * 64 * 4 + 4
                                         + 2 * 4 * 16 * 8)
    assert got["transcendentals"] == 2 * 4 * (64 + pairs)
    # the count does not depend on the design's chunk once S fits one chunk
    assert registry.get("ssd_scan.kernel").cost_estimate(b=2, s=64, h=4, g=1, p=16, n=8,
                                                         chunk=128) == got


def test_buckets_are_the_reference_power_of_two_buckets():
    assert registry.get("fastchar.table").bucket(n_bits=8, d=3284) == \
        ref_registry._char_bucket(n_bits=8, d=3284)
    assert registry.get("fastapp.table").bucket(n_bits=8, d=128, m=250, k=100, n=10) == \
        ref_registry._app_bucket(n_bits=8, d=128, m=250, k=100, n=10)
    assert registry.get("axo_matmul.kernel").bucket(m=24, k=7168, n=2048, rank=8) == \
        ref_registry._axo_bucket(m=24, k=7168, n=2048, rank=8)
    assert registry.get("attention.kernel").bucket(sq=128, skv=1500, hd=112) == \
        ref_registry._flash_bucket(sq=128, skv=1500, hd=112)
    assert registry.get("fastmoo.kernel").bucket(p=128, n_obj=2) == \
        ref_registry._moo_bucket(p=128, n_obj=2)
