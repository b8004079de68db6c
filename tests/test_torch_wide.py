"""Wide and unsigned operators in the port: sampled BEHAV, unsigned exhaustive BEHAV, ``entry_fn``.

Tolerances, as the port's contracts state them:

* sampled BEHAV (signed multipliers at 8/12/16 bits, adders) against the
  reference's ``fastchar.behav_metrics_sampled`` at the same seed: the
  integer channels (AVG_ABS_ERR, PROB_ERR, MAX_ABS_ERR, and MSE where it is
  summed in int64) bit for bit; AVG_ABS_REL_ERR, a float64 MSE and the
  bootstrap intervals to 1e-12 relative (float64 sums in another order);
* unsigned operators are held against the numpy oracle
  (``repro.core.metrics.behav_metrics``) and ``operator_model.entry_product``,
  never against the reference's device paths, which compute the signed
  operator for an unsigned spec: four metrics exactly, AVG_ABS_REL_ERR to
  1e-5 relative (f32 weights, as for the signed kernels);
* ``entry_fn`` equals the reference's exactly.
"""

import numpy as np
import pytest
import torch

from repro.core.metrics import behav_metrics as ref_behav_metrics
from repro.core.operator_model import entry_product as ref_entry_product
from repro.core.operator_model import exact_table as ref_exact_table
from repro.core.operator_model import product_tables as ref_product_tables
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch.core import fastchar
from repro_torch.core.dataset import characterize, gen_random
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.metrics import BEHAV_METRICS, behav_metrics
from repro_torch.core.operator_model import accurate_config, config_to_masks, spec_for
from repro_torch.kernels import char_kernels

CPU = ExecutionContext(device="cpu")
EXACT_KEYS = ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE")
REL_KEY = "AVG_ABS_REL_ERR"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_fastchar():
    """The reference's device engine (imports JAX, which the card's host lacks)."""
    pytest.importorskip("jax")
    from repro.core import fastchar as ref

    return ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _configs(spec, n, seed):
    """``n`` random configs, the accurate one first and the all-removed one last."""
    cfgs = np.random.default_rng(seed).integers(0, 2, (n, spec.n_luts)).astype(np.uint8)
    cfgs[0] = accurate_config(spec)
    cfgs[-1] = 0
    return cfgs


# ---------------------------------------------------------------------------
# Sampled BEHAV: parity with the reference
# ---------------------------------------------------------------------------


SAMPLED = [(8, "mul"), (12, "mul"), (16, "mul"), (8, "add"), (12, "add")]


def _assert_sampled_equal(got, want, float_keys):
    met, ci = got
    rmet, rci = want
    for k in BEHAV_METRICS:
        if k in float_keys:
            np.testing.assert_allclose(met[k], rmet[k], rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(met[k], rmet[k], err_msg=k)
    for k in rci:
        for a, b in zip(ci[k], rci[k]):
            np.testing.assert_allclose(a, b, rtol=1e-12, err_msg=f"ci {k}")


@pytest.mark.parametrize("n_bits,op", SAMPLED)
def test_sampled_matches_reference(ref_fastchar, n_bits, op):
    spec, rspec = spec_for(n_bits, op), ref_spec_for(n_bits, op)
    cfgs = _configs(spec, 6, n_bits)
    kw = dict(n_samples=6000, seed=3, s_block=2048, b_block=256)   # 3 ragged chunks
    got = fastchar.behav_metrics_sampled(spec, cfgs, ctx=CPU, **kw)
    want = ref_fastchar.behav_metrics_sampled(rspec, cfgs, **kw)
    total = 3 * 2048
    float_mse = fastchar.max_abs_error_bound(spec) ** 2 * total >= 1 << 62
    _assert_sampled_equal(got, want, (REL_KEY, "MSE") if float_mse else (REL_KEY,))
    for k in BEHAV_METRICS:
        assert got[0][k][0] == 0.0   # the accurate config


def test_sampled_at_full_size_matches_reference_12bit(ref_fastchar):
    """The size ``benchmarks/bench_fastchar.py`` samples at (32,768 pairs,
    where the 12-bit MSE is summed in float64)."""
    spec, rspec = spec_for(12), ref_spec_for(12)
    cfgs = _configs(spec, 4, 12)
    got = fastchar.behav_metrics_sampled(spec, cfgs, n_samples=32768, seed=0, ctx=CPU)
    want = ref_fastchar.behav_metrics_sampled(rspec, cfgs, n_samples=32768, seed=0)
    _assert_sampled_equal(got, want, (REL_KEY, "MSE"))


def _entry_product_metrics(spec, cfgs, n_samples, seed, s_block):
    """Sampled BEHAV recomputed from the numpy oracle ``entry_product`` at
    the codes the estimator draws, with unsigned exact products."""
    total = -(-n_samples // s_block) * s_block
    rng = np.random.default_rng(seed)
    a = rng.integers(0, spec.n_inputs, size=total)
    b = rng.integers(0, spec.n_inputs, size=total)
    rspec = ref_spec_for(spec.n_bits, spec.op, signed=False)
    masks = config_to_masks(spec, cfgs)
    approx = ref_entry_product(rspec, masks[:, None, :], a[None], b[None])
    exact = a * b if spec.op == "mul" else a + b
    err = np.abs(approx - exact[None])
    return {
        "AVG_ABS_ERR": err.sum(1) / total,
        "AVG_ABS_REL_ERR": 100.0 * (err / np.maximum(exact, 1)[None]).sum(1) / total,
        "PROB_ERR": 100.0 * (err != 0).sum(1) / total,
        "MAX_ABS_ERR": err.max(1).astype(np.float64),
        "MSE": (err * err).sum(1) / total,
    }


@pytest.mark.parametrize("n_bits,op", [(8, "mul"), (12, "mul"), (8, "add")])
def test_sampled_unsigned_matches_entry_product(n_bits, op):
    spec = spec_for(n_bits, op, signed=False)
    cfgs = _configs(spec, 5, n_bits + 1)
    met, ci = fastchar.behav_metrics_sampled(spec, cfgs, n_samples=4096, seed=7,
                                             s_block=2048, ctx=CPU)
    want = _entry_product_metrics(spec, cfgs, 4096, 7, 2048)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(met[k], want[k], err_msg=k)
    np.testing.assert_allclose(met[REL_KEY], want[REL_KEY], rtol=1e-12)
    assert met["AVG_ABS_ERR"][0] == 0.0 and met["AVG_ABS_ERR"][-1] > 0
    lo, hi = ci["AVG_ABS_ERR"]
    assert (lo <= met["AVG_ABS_ERR"]).all() and (met["AVG_ABS_ERR"] <= hi).all()


# ---------------------------------------------------------------------------
# Unsigned exhaustive BEHAV through K1's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits", [4, 6, 8])
@pytest.mark.parametrize("impl", ["table", "plain"])
def test_unsigned_exhaustive_matches_numpy_oracle(n_bits, impl):
    spec = spec_for(n_bits, signed=False)
    cfgs = _configs(spec, 12, n_bits)
    got = fastchar.behav_metrics_torch(spec, cfgs, impl=impl, batch_size=5, ctx=CPU)
    want = ref_behav_metrics(ref_spec_for(n_bits, signed=False), cfgs)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got[REL_KEY], want[REL_KEY], rtol=1e-5)
    assert got["MAX_ABS_ERR"][0] == 0.0


def test_unsigned_model_planes_are_the_unsigned_rows():
    """The planes K1 reads for an unsigned spec rebuild its product tables."""
    spec = spec_for(6, signed=False)
    cfgs = _configs(spec, 7, 5)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32))
    small = fastchar._model_planes(spec, masks)                # (R, D, 4, B)
    codes = torch.arange(spec.n_inputs)
    tabs = sum(small[r][:, 2 * ((codes >> 2 * r) & 1) + ((codes >> 2 * r + 1) & 1), :].long()
               << (2 * r) for r in range(spec.rows))
    np.testing.assert_array_equal(
        tabs.numpy(), ref_product_tables(ref_spec_for(6, signed=False), cfgs))


def test_characterize_unsigned_8bit_matches_numpy():
    spec = spec_for(8, signed=False)
    cfgs = gen_random(spec, 6, seed=4)
    ds_np = characterize(spec, cfgs, backend="numpy")
    ds_t = characterize(spec, cfgs, backend=CPU)
    for k in EXACT_KEYS + ("POWER", "CPD", "LUTS", "PDP", "PDPLUT"):
        np.testing.assert_array_equal(ds_np.metrics[k], ds_t.metrics[k], err_msg=k)
    np.testing.assert_allclose(ds_np.metrics[REL_KEY], ds_t.metrics[REL_KEY], rtol=1e-5)
    assert behav_metrics(spec, cfgs[:2], backend=CPU)["AVG_ABS_ERR"].shape == (2,)


@pytest.mark.parametrize("n_bits", [2, 4, 6, 8])
def test_unsigned_a_tile_keeps_partials_below_2_31(n_bits):
    """The signedness-aware bound holds for the unsigned family (checked on
    random, accurate and all-removed configs), and its tile keeps every int32
    tile partial below 2^30; at ``mul8u`` the signed formula (59,904) is not
    a bound (the all-removed config errs by 65,025)."""
    spec = spec_for(n_bits, signed=False)
    rspec = ref_spec_for(n_bits, signed=False)
    cfgs = _configs(spec, 64, n_bits)
    err = np.abs(ref_product_tables(rspec, cfgs).astype(np.int64) - ref_exact_table(rspec)[None])
    bound = fastchar.max_abs_error_bound(spec)
    tile = fastchar.default_a_tile(spec)
    assert err.max() <= bound
    assert tile * spec.n_inputs * bound < 1 << 30 and spec.n_inputs % tile == 0
    # every int channel of the tile partials, recomputed in int64, fits int32
    per_tile = err.reshape(len(cfgs), spec.n_inputs // tile, -1)
    hi, lo = per_tile >> 8, per_tile & 255
    for part in (per_tile, hi * hi, hi * lo, lo * lo):
        assert part.sum(-1).max() < 1 << 31
    if n_bits == 8:
        signed_formula = fastchar.max_abs_error_bound(spec_for(8))
        assert signed_formula == 59904 < err.max() == 65025 and bound == 86955


def test_k2_refuses_unsigned_and_wide_specs_raise():
    spec = spec_for(8, signed=False)
    cfgs = _configs(spec, 3, 1)
    with pytest.raises(ValueError, match="signed multiplier only"):
        fastchar.behav_metrics_torch(spec, cfgs, impl="entry", ctx=CPU)
    with pytest.raises(ValueError, match="signed multiplier only"):
        fastchar.behav_metrics_torch(spec, cfgs,
                                     ctx=ExecutionContext(device="cpu", kernel_impl="entry"))
    wide = spec_for(12)
    with pytest.raises(ValueError, match="behav_metrics_sampled"):
        characterize(wide, _configs(wide, 2, 0), backend=CPU)


# ---------------------------------------------------------------------------
# entry_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_bits,op", [(4, "mul"), (8, "mul"), (12, "mul"), (14, "mul"),
                                       (16, "add"), (8, "mul_u")])
def test_entry_fn_matches_reference(ref_fastchar, n_bits, op):
    signed = op != "mul_u"
    kind = "mul" if op == "mul_u" else op
    spec, rspec = spec_for(n_bits, kind, signed), ref_spec_for(n_bits, kind, signed)
    rng = np.random.default_rng(n_bits)
    a = rng.integers(0, spec.n_inputs, (5, 40))
    b = rng.integers(0, spec.n_inputs, (1, 40))
    fn, rfn = fastchar.entry_fn(spec), ref_fastchar.entry_fn(rspec)
    for cfg in (accurate_config(spec), rng.integers(0, 2, spec.n_luts).astype(np.uint8)):
        got = fn(torch.from_numpy(cfg), torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32 and got.shape == (5, 40)
        np.testing.assert_array_equal(got.numpy(), np.asarray(rfn(cfg, a, b)))


def test_entry_fn_refuses_16bit_multipliers():
    with pytest.raises(ValueError, match="overflow int32"):
        fastchar.entry_fn(spec_for(16))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_unsigned_8bit_through_k1_on_card(cuda):
    spec = spec_for(8, signed=False)
    cfgs = _configs(spec, 40, 8)
    before = char_kernels.behav_stats_table.launches
    got = behav_metrics(spec, cfgs, backend=ExecutionContext())
    assert char_kernels.behav_stats_table.launches == before + 1
    want = ref_behav_metrics(ref_spec_for(8, signed=False), cfgs)
    for k in EXACT_KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got[REL_KEY], want[REL_KEY], rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits,op,signed", [(12, "mul", True), (16, "mul", True),
                                              (8, "mul", False)])
def test_sampled_on_card_matches_the_cpu(cuda, n_bits, op, signed):
    spec = spec_for(n_bits, op, signed)
    cfgs = _configs(spec, 8, n_bits)
    kw = dict(n_samples=8192, seed=1)
    got = fastchar.behav_metrics_sampled(spec, cfgs, ctx=ExecutionContext(), **kw)
    want = fastchar.behav_metrics_sampled(spec, cfgs, ctx=CPU, **kw)
    _assert_sampled_equal(got, want, (REL_KEY, "MSE"))
