"""Port applications vs the reference: data, BEHAV, app DSE and state carried across.

Each app's BEHAV on the port's torch engine (on the CPU) is held against the
reference's numpy oracle and its JAX backend at the default sizes, 8 bits:
ecg and mnist (counts) exactly, gauss and ffn (float combines) to 1e-6
relative -- in practice they are exact too.  ``TransformerFFN(requant=
"device")`` is held to the reference's own tolerance, atol 2e-2 on BEHAV.
The app-targeted DSE at 4x4 is held to the reference numpy backend as
``tests/test_torch_dse.py`` holds the operator DSE: the validated front's
APP_MNIST equals the oracle, and the hypervolume is within 2% (on the mean
over seeds, see ``DSE_SEEDS``).
"""

import numpy as np
import pytest
import torch

from repro.apps import APPLICATIONS as REF_APPS
from repro.core import dse as ref_dse
from repro.core.automl import fit_estimators as ref_fit_estimators
from repro.core.dataset import build_training_dataset as ref_build
from repro.core.miqcp import _all_configs
from repro.core.operator_model import product_tables as ref_product_tables
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch import convert
from repro_torch.apps import APPLICATIONS, characterized_dataset_multi, fastapp
from repro_torch.core import dse
from repro_torch.core.dataset import Dataset
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.moo import pareto_mask
from repro_torch.core.operator_model import accurate_config, spec_for

CPU = ExecutionContext(device="cpu")
NAMES = sorted(APPLICATIONS)
COUNT_APPS = ("ecg", "mnist")     # count-based metrics: bit-identical
FLOAT_RTOL = 1e-6                 # gauss, ffn
# small instances for the exhaustive 4x4 sweeps (the reference tests' sizes)
SMALL_APPS = {
    "ecg": dict(n_samples=512),
    "mnist": dict(side=8, n_train_per_class=12, n_test_per_class=6),
    "gauss": dict(side=32),
    "ffn": dict(d_model=16, d_ff=32, n_tokens=12),
}
DSE_SETTINGS = dict(behav_key="APP_MNIST", const_sf=1.0, pop_size=24, n_gen=12,
                    n_quad_grid=(0, 4), pool_size=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _assert_behav(name, got, want):
    if name in COUNT_APPS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-12)


def _configs8():
    """14 random 8-bit configs, the all-zeros config and the accurate config."""
    spec = spec_for(8)
    rng = np.random.default_rng(0)
    cfgs = rng.integers(0, 2, (14, spec.n_luts)).astype(np.uint8)
    return np.concatenate(
        [cfgs, np.zeros((1, spec.n_luts), np.uint8), accurate_config(spec)[None]]
    )


@pytest.fixture(scope="module")
def ref_apps():
    return {name: REF_APPS[name]() for name in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_generators_rebuild_the_reference_data(ref_apps, name):
    ref, app = ref_apps[name], APPLICATIONS[name]()
    for key in convert.APP_ARRAYS[name] + ("_x_codes",) * (name in ("mnist", "ffn")):
        np.testing.assert_array_equal(getattr(app, key), getattr(ref, key), err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_behav_at_default_sizes_matches_reference(ref_apps, name):
    """Port torch and numpy backends vs the reference numpy and JAX backends."""
    cfgs = _configs8()
    ref, app = ref_apps[name], APPLICATIONS[name]()
    want = ref.behav(ref_spec_for(8), cfgs, backend="numpy")
    np.testing.assert_array_equal(app.behav(spec_for(8), cfgs, backend="numpy"), want)
    got = app.behav(spec_for(8), cfgs, backend=CPU)
    _assert_behav(name, got, want)
    assert got[-1] == app.accurate_behav(spec_for(8), backend=CPU)
    pytest.importorskip("jax")
    _assert_behav(name, got, ref.behav(ref_spec_for(8), cfgs, backend="jax"))


@pytest.mark.parametrize("impl", ["entry", "gemm", "plain", "entry_gather"])
def test_behav_every_route_matches_the_oracle(ref_apps, impl):
    cfgs = _configs8()
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    for name in NAMES:
        want = ref_apps[name].behav(ref_spec_for(8), cfgs, backend="numpy")
        _assert_behav(name, APPLICATIONS[name]().behav(spec_for(8), cfgs, backend=ctx), want)


@pytest.mark.parametrize("name", NAMES)
def test_exhaustive_4x4_all_1024_configs(name):
    cfgs = _all_configs(spec_for(4).n_luts)
    want = REF_APPS[name](**SMALL_APPS[name]).behav(ref_spec_for(4), cfgs, backend="numpy")
    got = APPLICATIONS[name](**SMALL_APPS[name]).behav(spec_for(4), cfgs, backend=CPU)
    _assert_behav(name, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_degenerate_shapes(name):
    """D=1 batches and single-sample datasets evaluate identically."""
    kwargs = dict(SMALL_APPS[name])
    kwargs.update({"mnist": dict(n_test_per_class=1), "ffn": dict(n_tokens=1),
                   "ecg": dict(n_samples=300)}.get(name, {}))
    cfg = np.random.default_rng(2).integers(0, 2, (1, spec_for(8).n_luts)).astype(np.uint8)
    want = REF_APPS[name](**kwargs).behav(ref_spec_for(8), cfg, backend="numpy")
    got = APPLICATIONS[name](**kwargs).behav(spec_for(8), cfg, backend=CPU)
    np.testing.assert_allclose(got, want, rtol=FLOAT_RTOL, atol=1e-9)


def test_chunking_invariance():
    app = APPLICATIONS["mnist"](**SMALL_APPS["mnist"])
    cfgs = np.random.default_rng(3).integers(0, 2, (37, spec_for(4).n_luts)).astype(np.uint8)
    want = app.behav(spec_for(4), cfgs, batch=128, backend=CPU)
    for b in (8, 16, 37):
        np.testing.assert_array_equal(app.behav(spec_for(4), cfgs, batch=b, backend=CPU), want)


def test_ffn_device_requant_within_tolerance():
    """GEMM1 -> GeLU -> requant -> GEMM2 on the device in float32 agrees with the
    bit-exact host float64 requant to the reference's tolerance; the chain
    composes with the table-free routes (no table is built)."""
    spec = spec_for(8)
    rng = np.random.default_rng(11)
    cfgs = np.ones((6, spec.n_luts), dtype=np.uint8)
    for i in range(1, 6):  # mild approximations: flip i random LUTs
        cfgs[i, rng.choice(spec.n_luts, size=i, replace=False)] = 0
    tabs = torch.from_numpy(ref_product_tables(ref_spec_for(8), cfgs))
    kw = dict(d_model=16, d_ff=24, n_tokens=12)
    ref_host = REF_APPS["ffn"](**kw).behav_from_tables(tabs.numpy())
    host = APPLICATIONS["ffn"](**kw).behav_torch_from_tables(tabs)
    np.testing.assert_array_equal(host, ref_host)
    dev = APPLICATIONS["ffn"](**kw, requant="device").behav_torch_from_tables(tabs)
    np.testing.assert_allclose(dev, host, atol=2e-2)
    batch = fastapp.table_batch(spec, cfgs, ctx=ExecutionContext(device="cpu",
                                                                 kernel_impl="entry"))
    entry = APPLICATIONS["ffn"](**kw, requant="device").behav_torch_from_tables(batch)
    np.testing.assert_allclose(entry, dev, atol=1e-9)
    assert batch._tables is None


def test_ffn_device_requant_at_default_size(ref_apps):
    cfgs = _configs8()
    want = ref_apps["ffn"].behav(ref_spec_for(8), cfgs, backend="numpy")
    got = APPLICATIONS["ffn"](requant="device").behav(spec_for(8), cfgs, backend=CPU)
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_characterized_dataset_multi_matches_per_app(backend):
    """One shared table pass per chunk == four one-app-at-a-time passes."""
    ctx = CPU if backend == "torch" else "numpy"
    spec = spec_for(4)
    rng = np.random.default_rng(3)
    cfgs = np.concatenate([rng.integers(0, 2, (9, spec.n_luts)).astype(np.uint8),
                           accurate_config(spec)[None]])
    base = Dataset(configs=cfgs, metrics={"X": np.arange(10.0)}, source=np.zeros(10))
    apps = [APPLICATIONS[n](**SMALL_APPS[n]) for n in NAMES]
    multi = characterized_dataset_multi(apps, spec, base, backend=ctx, batch=4)
    np.testing.assert_array_equal(multi.metrics["X"], base.metrics["X"])
    for app in apps:
        key = app.behav_metric_name()
        want = REF_APPS[app.name](**SMALL_APPS[app.name]).behav(ref_spec_for(4), cfgs,
                                                                backend="numpy")
        np.testing.assert_array_equal(
            multi.metrics[key], app.characterized_dataset(spec, base, backend=ctx).metrics[key]
        )
        _assert_behav(app.name, multi.metrics[key], want)


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trip(ref_apps, name):
    kw = {**SMALL_APPS[name], "seed": 5}
    ref = REF_APPS[name](**kw)
    state = convert.state_of(ref)
    assert state["kind"] == "app" and state["fields"]["seed"] == 5
    app = convert.from_state(state)
    assert type(app) is APPLICATIONS[name]
    for key in convert.APP_ARRAYS[name]:
        np.testing.assert_array_equal(getattr(app, key), getattr(ref, key))
    again = convert.from_state(convert.state_of(app))
    cfgs = np.random.default_rng(4).integers(0, 2, (6, spec_for(4).n_luts)).astype(np.uint8)
    want = ref.behav(ref_spec_for(4), cfgs, backend="numpy")
    _assert_behav(name, app.behav(spec_for(4), cfgs, backend=CPU), want)
    np.testing.assert_array_equal(again.behav(spec_for(4), cfgs, backend="numpy"), want)


def test_convert_carries_arrays_not_regenerated():
    """State carried across wins over the port's own generator."""
    ref = REF_APPS["mnist"](**SMALL_APPS["mnist"])
    state = convert.state_of(ref)
    state["arrays"]["_W"] = state["arrays"]["_W"][:, ::-1].copy()
    app = convert.from_state(state)
    ref._W = state["arrays"]["_W"]
    ref._prep_bits = 0
    cfgs = np.random.default_rng(5).integers(0, 2, (6, spec_for(4).n_luts)).astype(np.uint8)
    np.testing.assert_array_equal(app.behav(spec_for(4), cfgs, backend=CPU),
                                  ref.behav(ref_spec_for(4), cfgs, backend="numpy"))


@pytest.fixture(scope="module")
def dse_setup():
    rspec = ref_spec_for(4)
    rapp = REF_APPS["mnist"](**SMALL_APPS["mnist"])
    rbase = ref_build(rspec, n_random=300, seed=0)
    rds = rapp.characterized_dataset(rspec, rbase, backend="numpy")
    rst = ref_dse.DSESettings(**DSE_SETTINGS, seed=0)
    rests = ref_fit_estimators(
        rds.configs.astype(np.float64),
        {k: rds.metrics[k] for k in (rst.behav_key, rst.ppa_key)},
        n_quad=rst.n_estimator_quad, seed=rst.seed,
    )
    rpool = ref_dse.map_solution_pool(rspec, rds, rst)
    ref = ref_dse.hv_reference(rds, rst)
    return dict(
        rspec=rspec, rapp=rapp, rds=rds, rst=rst, rests=rests, rpool=rpool, ref=ref,
        app=convert.from_state(convert.state_of(rapp)),
        ds=convert.from_state(convert.state_of(rds)),
        ests={k: convert.from_state(convert.state_of(v)) for k, v in rests.items()},
    )


# At this size APP_MNIST takes few values, so one run's validated-front
# hypervolume moves by several percent from seed to seed on either side (the
# reference's own JAX GA is 4.9% off its numpy GA at seed 3 of map+ga): the 2%
# contract is held on the mean over seeds, the exact checks on every run.
DSE_SEEDS = {"ga": range(10), "map": range(1), "map+ga": range(10)}


@pytest.mark.parametrize("method", ["ga", "map", "map+ga"])
def test_run_dse_app_mnist_matches_reference(dse_setup, method):
    s = dse_setup
    hv_ref, hv_port = [], []
    for seed in DSE_SEEDS[method]:
        want = ref_dse.run_dse(s["rspec"], s["rds"], method,
                               settings=ref_dse.DSESettings(**DSE_SETTINGS, seed=seed),
                               estimators=s["rests"], map_pool=s["rpool"], ref=s["ref"],
                               app=s["rapp"])
        got = dse.run_dse(spec_for(4), s["ds"], method,
                          settings=dse.DSESettings(**DSE_SETTINGS, seed=seed, context=CPU),
                          estimators=s["ests"], map_pool=s["rpool"], ref=s["ref"],
                          app=s["app"])
        assert want.hv_vpf > 0 and len(got.vpf_configs) > 0
        assert got.n_evals == want.n_evals
        assert pareto_mask(got.vpf_objs).all()
        # the validated front's APP_MNIST is the reference numpy app BEHAV
        np.testing.assert_array_equal(
            got.vpf_objs[:, 0], s["rapp"].behav(s["rspec"], got.vpf_configs, backend="numpy")
        )
        rchar = s["rapp"].characterize_fn(s["rspec"], backend="numpy")(got.vpf_configs)
        np.testing.assert_array_equal(got.vpf_objs[:, 1], rchar[:, 1])
        hv_ref.append(want.hv_vpf)
        hv_port.append(got.hv_vpf)
    assert abs(np.mean(hv_port) - np.mean(hv_ref)) <= 0.02 * np.mean(hv_ref)


def test_run_dse_app_numpy_backend_is_the_reference(dse_setup):
    s = dse_setup
    want = ref_dse.run_dse(s["rspec"], s["rds"], "map+ga", settings=s["rst"],
                           estimators=s["rests"], map_pool=s["rpool"], ref=s["ref"],
                           app=s["rapp"])
    got = dse.run_dse(spec_for(4), s["ds"], "map+ga",
                      settings=dse.DSESettings(**DSE_SETTINGS, seed=0,
                                               context=ExecutionContext(backend="numpy")),
                      estimators=s["ests"], map_pool=s["rpool"], ref=s["ref"], app=s["app"])
    assert got.hv_vpf == want.hv_vpf and got.hv_ppf == want.hv_ppf
    np.testing.assert_array_equal(got.vpf_configs, want.vpf_configs)
    np.testing.assert_array_equal(got.vpf_objs, want.vpf_objs)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["table", "entry"])
def test_app_behav_on_card_matches_oracle(cuda, impl):
    from repro_torch.kernels import app_kernels

    cfgs = _configs8()
    ctx = ExecutionContext(kernel_impl=impl)
    wrapper = app_kernels.table_gemv if impl == "table" else app_kernels.entry_gemv
    before = wrapper.launches
    for name in NAMES:
        app = APPLICATIONS[name]()
        _assert_behav(name, app.behav(spec_for(8), cfgs, backend=ctx),
                      app.behav(spec_for(8), cfgs, backend="numpy"))
    assert wrapper.launches > before
