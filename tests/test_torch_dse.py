"""End-to-end DSE of the port vs the reference, on the 4x4 operator.

The training set and the fitted estimators are carried across from the
reference, so both sides search the same surrogate.  The MaP pool must equal
the reference's; the torch GA uses other random streams, so each method's
validated-front hypervolume is held within 2% of the reference numpy
backend; the validated front's BEHAV must equal the reference numpy
characterization of the same configs (four metrics exactly, the relative
error to 1e-5).
"""

import numpy as np
import pytest
import torch

from repro.core import dse as ref_dse
from repro.core.automl import fit_estimators as ref_fit_estimators
from repro.core.dataset import build_training_dataset as ref_build
from repro.core.dataset import characterize as ref_characterize
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch import convert
from repro_torch.core import dse
from repro_torch.core.dataset import characterize
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.moo import pareto_mask
from repro_torch.core.operator_model import spec_for

SETTINGS = dict(const_sf=0.5, pop_size=24, n_gen=12, n_quad_grid=(0, 4), pool_size=4, seed=0)
EXACT_KEYS = ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are tiny: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rspec = ref_spec_for(4)
    rds = ref_build(rspec, n_random=300, seed=0)
    rst = ref_dse.DSESettings(**SETTINGS)
    rests = ref_fit_estimators(
        rds.configs.astype(np.float64),
        {k: rds.metrics[k] for k in (rst.behav_key, rst.ppa_key)},
        n_quad=rst.n_estimator_quad, seed=rst.seed,
    )
    rpool = ref_dse.map_solution_pool(rspec, rds, rst)
    ref = ref_dse.hv_reference(rds, rst)
    ds = convert.from_state(convert.state_of(rds))
    ests = {k: convert.from_state(convert.state_of(v)) for k, v in rests.items()}
    return dict(rspec=rspec, rds=rds, rst=rst, rests=rests, rpool=rpool, ref=ref,
                ds=ds, ests=ests)


def _settings(ctx):
    return dse.DSESettings(**SETTINGS, context=ctx)


def test_map_pool_equals_reference(setup):
    pool = dse.map_solution_pool(spec_for(4), setup["ds"],
                                 _settings(ExecutionContext(device="cpu")))
    np.testing.assert_array_equal(pool, setup["rpool"])


@pytest.mark.parametrize("method", ["ga", "map", "map+ga"])
def test_torch_backend_hv_within_2pct_of_reference(setup, method):
    s = setup
    want = ref_dse.run_dse(s["rspec"], s["rds"], method, settings=s["rst"],
                           estimators=s["rests"], map_pool=s["rpool"], ref=s["ref"])
    got = dse.run_dse(spec_for(4), s["ds"], method,
                      settings=_settings(ExecutionContext(device="cpu")),
                      estimators=s["ests"], map_pool=s["rpool"], ref=s["ref"])
    assert want.hv_vpf > 0
    assert abs(got.hv_vpf - want.hv_vpf) <= 0.02 * want.hv_vpf
    assert got.n_evals == want.n_evals
    assert set(got.timings) == {"characterize", "ga", "validate"}
    if len(got.vpf_objs):
        assert pareto_mask(got.vpf_objs).all()
        # the validated front's BEHAV is the reference numpy characterization
        oracle = ref_characterize(s["rspec"], got.vpf_configs)
        np.testing.assert_allclose(got.vpf_objs[:, 0], oracle.metrics[s["rst"].behav_key],
                                   rtol=1e-5)
        np.testing.assert_array_equal(got.vpf_objs[:, 1], oracle.metrics[s["rst"].ppa_key])
        ours = characterize(spec_for(4), got.vpf_configs,
                            backend=ExecutionContext(device="cpu"))
        for k in EXACT_KEYS:
            np.testing.assert_array_equal(ours.metrics[k], oracle.metrics[k], err_msg=k)


@pytest.mark.parametrize("method", ["ga", "map", "map+ga"])
def test_numpy_backend_is_the_reference_bit_for_bit(setup, method):
    s = setup
    want = ref_dse.run_dse(s["rspec"], s["rds"], method, settings=s["rst"],
                           estimators=s["rests"], map_pool=s["rpool"], ref=s["ref"])
    got = dse.run_dse(spec_for(4), s["ds"], method,
                      settings=_settings(ExecutionContext(backend="numpy")),
                      estimators=s["ests"], map_pool=s["rpool"], ref=s["ref"])
    assert got.hv_vpf == want.hv_vpf and got.hv_ppf == want.hv_ppf
    np.testing.assert_array_equal(got.vpf_configs, want.vpf_configs)
    assert got.hv_history == want.hv_history


def test_run_dse_fits_estimators_and_solves_pool_itself(setup):
    st = dse.DSESettings(const_sf=1.0, pop_size=12, n_gen=3, n_quad_grid=(0,),
                         pool_size=2, seed=0, context=ExecutionContext(device="cpu"))
    r = dse.run_dse(spec_for(4), setup["ds"], "map+ga", settings=st)
    assert set(r.timings) == {"characterize", "map", "ga", "validate"}
    assert r.n_evals == 12 * 4 and r.hv_ppf >= 0 and r.hv_vpf >= 0
    assert [n for n, _ in r.hv_history] == [12, 48]


def test_bad_arguments_and_fixed_library(setup):
    with pytest.raises(ValueError):
        dse.run_dse(spec_for(4), setup["ds"], "anneal",
                    settings=_settings(ExecutionContext(device="cpu")))
    with pytest.raises(TypeError):
        dse.DSESettings(context="torch")
    np.testing.assert_array_equal(dse.fixed_library(spec_for(8)),
                                  ref_dse.fixed_library(ref_spec_for(8)))
