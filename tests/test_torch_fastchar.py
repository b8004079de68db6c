"""Port characterization vs the reference: plain K1/K2 versions and BEHAV metrics.

The reference's Pallas wrappers do not run on the installed JAX, so the port
is held against the reference's XLA twin ``fastchar._partials_xla`` (same
tiling, same channels) and its numpy oracle ``metrics.behav_metrics``: int
channels and four metrics bit-for-bit, the f32 relative channel to 1e-5
relative (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

from repro.core.metrics import behav_metrics as ref_behav_metrics
from repro.core.miqcp import _all_configs
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch.core import fastchar
from repro_torch.core.dataset import characterize
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.metrics import BEHAV_METRICS, behav_metrics
from repro_torch.core.operator_model import (
    _synth_small,
    accurate_config,
    config_to_masks,
    spec_for,
)
from repro_torch.kernels import char_kernels

EXACT_KEYS = ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE")
REL_KEY = "AVG_ABS_REL_ERR"
CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are tiny: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_fastchar():
    """The reference's XLA engine (imports JAX, which the card's host lacks)."""
    pytest.importorskip("jax")
    from repro.core import fastchar as ref

    return ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def plain_partials(masks, n_bits, a_tile, source):
    """K1's (``"table"``) or K2's (``"entry"``) plain version on a mask batch."""
    if source == "entry":
        return char_kernels.behav_stats_entry_plain(masks, n_bits, a_tile)
    _, exact, w = fastchar._device_tables(n_bits, str(masks.device))
    return char_kernels.behav_stats_table_plain(
        fastchar._gather_small(masks, n_bits), exact, w, a_tile
    )


def assert_parity(oracle, fast, rel_tol=1e-5):
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(oracle[k], fast[k], err_msg=k)
    np.testing.assert_allclose(oracle[REL_KEY], fast[REL_KEY], rtol=rel_tol, atol=1e-12)


def _configs8(n, seed):
    spec = spec_for(8)
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 2, (n, spec.n_luts)).astype(np.uint8)
    return np.concatenate(
        [cfgs, accurate_config(spec)[None], np.zeros((1, spec.n_luts), np.uint8)]
    )


@pytest.fixture(scope="module")
def oracle8():
    cfgs = _configs8(64, 0)
    return cfgs, ref_behav_metrics(ref_spec_for(8), cfgs)


@pytest.mark.parametrize("source", ["table", "entry"])
def test_plain_partials_match_reference_xla_twin(ref_fastchar, source):
    import jax.numpy as jnp

    spec = spec_for(8)
    cfgs = _configs8(64, 1)
    masks = config_to_masks(spec, cfgs).astype(np.int32)
    a_tile = fastchar.default_a_tile(spec)
    want_i, want_r = ref_fastchar._partials_xla(
        jnp.asarray(masks), 8, a_tile, len(masks), source=source
    )
    got_i, got_r = plain_partials(torch.from_numpy(masks), 8, a_tile, source)
    np.testing.assert_array_equal(np.asarray(want_i), got_i.numpy())
    np.testing.assert_allclose(np.asarray(want_r), got_r.numpy(), rtol=1e-5)


def test_plain_k1_and_k2_int_channels_agree():
    spec = spec_for(8)
    masks = torch.from_numpy(config_to_masks(spec, _configs8(32, 2)).astype(np.int32))
    i1, r1 = plain_partials(masks, 8, 64, "table")
    i2, r2 = plain_partials(masks, 8, 64, "entry")
    assert torch.equal(i1, i2)
    torch.testing.assert_close(r1, r2, rtol=1e-5, atol=0)


def test_exhaustive_4x4_all_1024_configs():
    spec = spec_for(4)
    cfgs = _all_configs(spec.n_luts)
    oracle = ref_behav_metrics(ref_spec_for(4), cfgs)
    for impl in fastchar.CHAR_IMPLS:
        ctx = ExecutionContext(device="cpu", kernel_impl=impl)
        assert_parity(oracle, behav_metrics(spec, cfgs, backend=ctx))


@pytest.mark.parametrize("impl", fastchar.CHAR_IMPLS)
def test_8x8_random_and_degenerate_configs(oracle8, impl):
    cfgs, oracle = oracle8
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    fast = behav_metrics(spec_for(8), cfgs, backend=ctx)
    assert_parity(oracle, fast)
    for k in BEHAV_METRICS:  # the accurate config is error-free
        assert fast[k][-2] == 0.0, k


def test_chunking_invariance():
    spec = spec_for(4)
    rng = np.random.default_rng(2)
    cfgs = rng.integers(0, 2, (37, spec.n_luts)).astype(np.uint8)  # odd D
    ref = fastchar.behav_metrics_torch(spec, cfgs, batch_size=1024, ctx=CPU)
    for bs in (1, 8, 16, 37):
        out = fastchar.behav_metrics_torch(spec, cfgs, batch_size=bs, ctx=CPU)
        for k in EXACT_KEYS:
            np.testing.assert_array_equal(ref[k], out[k], err_msg=f"{k} bs={bs}")
        np.testing.assert_allclose(ref[REL_KEY], out[REL_KEY], rtol=1e-6)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32))
    small = fastchar._gather_small(masks, 4)
    _, exact, w = fastchar._device_tables(4, "cpu")
    want = char_kernels.behav_stats_table_plain(small, exact, w, 16)
    for db in (1, 5, 64):
        got = char_kernels.behav_stats_table_plain(small, exact, w, 16, d_block=db)
        assert torch.equal(want[0], got[0])
        torch.testing.assert_close(want[1], got[1], rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_bits", [2, 4, 8])
def test_a_tile_rule_matches_reference(ref_fastchar, n_bits):
    spec, rspec = spec_for(n_bits), ref_spec_for(n_bits)
    assert fastchar.max_abs_error_bound(spec) == ref_fastchar.max_abs_error_bound(rspec)
    assert fastchar.default_a_tile(spec) == ref_fastchar.default_a_tile(rspec)
    tile = fastchar.default_a_tile(spec)
    assert tile * spec.n_inputs * fastchar.max_abs_error_bound(spec) < 2**30
    assert spec.n_inputs % tile == 0


def test_gathered_and_synthesized_planes_agree():
    spec = spec_for(8)
    masks = torch.from_numpy(config_to_masks(spec, _configs8(16, 3)).astype(np.int32))
    synth = torch.stack(_synth_small(spec, masks, torch, torch.int32))
    assert torch.equal(fastchar._gather_small(masks, 8), synth)


def test_characterize_torch_matches_numpy():
    spec = spec_for(4)
    rng = np.random.default_rng(3)
    cfgs = rng.integers(0, 2, (24, spec.n_luts)).astype(np.uint8)
    ds_np = characterize(spec, cfgs, backend="numpy")
    ds_t = characterize(spec, cfgs, backend=CPU)
    for k in EXACT_KEYS + ("POWER", "CPD", "LUTS", "PDP", "PDPLUT"):
        np.testing.assert_array_equal(ds_np.metrics[k], ds_t.metrics[k], err_msg=k)
    np.testing.assert_allclose(ds_np.metrics[REL_KEY], ds_t.metrics[REL_KEY], rtol=1e-5)


def test_unported_families_and_bad_inputs_raise():
    cfg = accurate_config(spec_for(4))[None]
    wide = spec_for(12)
    with pytest.raises(ValueError, match="behav_metrics_sampled"):
        fastchar.behav_metrics_torch(wide, accurate_config(wide)[None], ctx=CPU)
    with pytest.raises(ValueError, match="behav_metrics_sampled"):
        fastchar.behav_metrics_torch(spec_for(4, op="add"), cfg[:, :4], ctx=CPU)
    with pytest.raises(ValueError):
        fastchar.behav_metrics_torch(spec_for(4), cfg, impl="pallas", ctx=CPU)
    masks = torch.zeros((3, 4), dtype=torch.int64)
    with pytest.raises(TypeError):
        char_kernels.behav_stats_entry(masks, 8, 64)
    with pytest.raises(ValueError):
        char_kernels.behav_stats_entry(masks.to(torch.int32), 8, 48)


@pytest.mark.parametrize("n_bits,a_tile,d,want", [
    (8, 64, 258, 4), (8, 64, 132, 4), (8, 64, 128, 1), (8, 64, 64, 1), (8, 64, 37, 1),
    (8, 8, 37, 4), (4, 16, 258, 1), (4, 1, 258, 1), (4, 1, 600, 4),
])
def test_k2_configs_a_thread_rule(n_bits, a_tile, d, want):
    """K2's walk takes 4 configs a thread where that grid still has a block
    for every one of 132 SMs, else 1; any other count raises, and a CPU
    tensor runs the plain version whatever the count."""
    assert char_kernels.entry_configs(d, n_bits, a_tile, 132) == want
    cfgs = np.random.default_rng(d).integers(0, 2, (3, spec_for(4).n_luts)).astype(np.uint8)
    masks = torch.from_numpy(config_to_masks(spec_for(4), cfgs).astype(np.int32))
    want_i, want_r = char_kernels.behav_stats_entry_plain(masks, 4, 4)
    for g in (4, 1):
        got_i, got_r = char_kernels.behav_stats_entry_at(masks, 4, 4, g)
        assert torch.equal(got_i, want_i) and torch.equal(got_r, want_r)
    with pytest.raises(ValueError, match="4 or 1"):
        char_kernels.behav_stats_entry_at(masks, 4, 4, 2)


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_card(cuda):
    spec = spec_for(8)
    masks = torch.from_numpy(config_to_masks(spec, _configs8(256, 4)).astype(np.int32)).to(cuda)
    small = fastchar._gather_small(masks, 8)
    _, exact, w = fastchar._device_tables(8, str(masks.device))
    i1, r1 = char_kernels.behav_stats_table(small, exact, w, 64)
    i0, r0 = char_kernels.behav_stats_table_plain(small, exact, w, 64)
    i2, r2 = char_kernels.behav_stats_entry(masks, 8, 64)
    i3, r3 = char_kernels.behav_stats_entry_plain(masks, 8, 64)
    torch.cuda.synchronize()
    assert torch.equal(i1, i0) and torch.equal(i2, i3) and torch.equal(i1, i2)
    torch.testing.assert_close(r1, r0, rtol=1e-5, atol=0)
    torch.testing.assert_close(r2, r3, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [4, 8])
def test_k1_walk_and_first_design_match_at_a_ragged_d(cuda, n_bits):
    """K1's register walk and its first design at D=37 (the walk's last
    4-config group holds one), every a_tile the walk's template takes a path
    through (GB 0..6: a_tile 1 .. 64), int channels exactly, the f32 channel
    to 1e-5; each call counts one launch on its own wrapper."""
    spec = spec_for(n_bits)
    rng = np.random.default_rng(37 + n_bits)
    cfgs = rng.integers(0, 2, (37, spec.n_luts)).astype(np.uint8)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32)).to(cuda)
    small = fastchar._gather_small(masks, n_bits)
    _, exact, w = fastchar._device_tables(n_bits, str(masks.device))
    for a_tile in [t for t in (1, 2, 4, 8, 16, 32, 64) if t <= spec.n_inputs]:
        before = (char_kernels.behav_stats_table.launches,
                  char_kernels.behav_stats_table_first.launches)
        i1, r1 = char_kernels.behav_stats_table(small, exact, w, a_tile)
        i0, r0 = char_kernels.behav_stats_table_first(small, exact, w, a_tile)
        ip, rp = char_kernels.behav_stats_table_plain(small, exact, w, a_tile)
        torch.cuda.synchronize()
        assert torch.equal(i1, ip) and torch.equal(i0, ip), a_tile
        torch.testing.assert_close(r1, rp, rtol=1e-5, atol=0)
        torch.testing.assert_close(r0, rp, rtol=1e-5, atol=0)
        assert (char_kernels.behav_stats_table.launches,
                char_kernels.behav_stats_table_first.launches) == (before[0] + 1,
                                                                   before[1] + 1)


@pytest.mark.gpu
def test_behav_metrics_on_card_match_oracle(cuda, oracle8):
    cfgs, oracle = oracle8
    for impl in ("table", "entry"):
        before = (char_kernels.behav_stats_table.launches,
                  char_kernels.behav_stats_entry.launches)
        fast = behav_metrics(spec_for(8), cfgs, backend=ExecutionContext(kernel_impl=impl))
        assert_parity(oracle, fast)
        after = (char_kernels.behav_stats_table.launches,
                 char_kernels.behav_stats_entry.launches)
        assert after[impl == "entry"] > before[impl == "entry"]


@pytest.mark.gpu
@pytest.mark.parametrize("n_cfgs", [258, 37, 5])
@pytest.mark.parametrize("n_bits", [4, 8])
def test_k2_walk_and_first_design_match_on_card(cuda, n_bits, n_cfgs):
    """K2's synthesized walk, at the configs a thread its rule picks and at
    both of its tiers (4 and 1), and its first design at D=258, a ragged D=37
    and D=5 (below the SM count: 1 config a thread), every a_tile the walk's
    template takes a path through, against the plain version and, on the int
    channels, K1 on the same configs; each call counts one launch on its own
    wrapper."""
    spec = spec_for(n_bits)
    rng = np.random.default_rng(n_cfgs + n_bits)
    cfgs = rng.integers(0, 2, (n_cfgs, spec.n_luts)).astype(np.uint8)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32)).to(cuda)
    small = fastchar._gather_small(masks, n_bits)
    _, exact, w = fastchar._device_tables(n_bits, str(masks.device))
    for a_tile in [t for t in (1, 2, 4, 8, 16, 32, 64) if t <= spec.n_inputs]:
        before = (char_kernels.behav_stats_entry.launches,
                  char_kernels.behav_stats_entry_first.launches)
        walks = [char_kernels.behav_stats_entry(masks, n_bits, a_tile)] + [
            char_kernels.behav_stats_entry_at(masks, n_bits, a_tile, g) for g in (4, 1)]
        i0, r0 = char_kernels.behav_stats_entry_first(masks, n_bits, a_tile)
        ip, rp = char_kernels.behav_stats_entry_plain(masks, n_bits, a_tile)
        i1, _ = char_kernels.behav_stats_table(small, exact, w, a_tile)
        torch.cuda.synchronize()
        assert torch.equal(i0, ip) and torch.equal(i1, ip), a_tile
        torch.testing.assert_close(r0, rp, rtol=1e-5, atol=0)
        for i2, r2 in walks:
            assert torch.equal(i2, ip), a_tile
            torch.testing.assert_close(r2, rp, rtol=1e-5, atol=0)
        assert (char_kernels.behav_stats_entry.launches,
                char_kernels.behav_stats_entry_first.launches) == (before[0] + 3,
                                                                   before[1] + 1)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = char_kernels.entry_configs(n_cfgs, n_bits, 64 if n_bits == 8 else 16, n_sms)
    assert (g == 4) == (n_cfgs == 258 and n_bits == 8 and n_sms <= 260)
