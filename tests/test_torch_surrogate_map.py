"""Port surrogate and MaP scoring vs the reference's numpy estimators and solvers.

Fitted state crosses over through ``repro_torch.convert`` so both sides
compute from the same coefficients and trees.  The device surrogate is f32,
held to the reference test's tolerance (1e-4 of the output scale); MaP values
to 1e-4 absolute; the lockstep tabu must find the serial numpy solver's best.
"""

import numpy as np
import pytest
import torch

from repro.core.automl import fit_estimators as ref_fit_estimators
from repro.core.correlation import rank_quadratic_terms as ref_rank
from repro.core.dataset import build_training_dataset as ref_build
from repro.core.gbt import GBTRegressor as RefGBT
from repro.core.miqcp import (
    _all_configs,
    build_problems as ref_build_problems,
    solve_tabu as ref_solve_tabu,
)
from repro.core.operator_model import spec_for as ref_spec_for
from repro.core.regression import fit_poly as ref_fit_poly

from repro_torch import convert
from repro_torch.core import fastchar, miqcp
from repro_torch.core.automl import fit_estimators
from repro_torch.core.correlation import rank_quadratic_terms
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.regression import fit_poly

CPU = ExecutionContext(device="cpu")
KEYS = ("AVG_ABS_REL_ERR", "PDPLUT")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are tiny: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fitted():
    ds = ref_build(ref_spec_for(4), n_random=200, seed=0)
    X = ds.configs.astype(np.float64)
    ests = ref_fit_estimators(X, {k: ds.metrics[k] for k in KEYS}, n_quad=16, seed=0)
    return ds, ests


def _problems(ds, n_quad, const_sf, wt):
    X = ds.configs.astype(float)
    yb, yp = ds.metrics[KEYS[0]], ds.metrics[KEYS[1]]
    bm = ref_fit_poly(X, yb, quad_pairs=ref_rank(X, yb)[:n_quad])
    pm = ref_fit_poly(X, yp, quad_pairs=ref_rank(X, yp)[:n_quad])
    return ref_build_problems(bm, pm, float(yb.max()), float(yp.max()), const_sf,
                              wt_grid=np.asarray(wt), n_quad=n_quad)


def _port(obj):
    return convert.from_state(convert.state_of(obj))


def _assert_same_state(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_state(a[k], b[k])
    elif isinstance(a, list) and a and isinstance(a[0], dict):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_state(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_state_round_trip_and_host_fits_match_reference(fitted):
    ds, ests = fitted
    port_ds = _port(ds)
    _assert_same_state(convert.state_of(ds), convert.state_of(port_ds))
    X = port_ds.configs.astype(np.float64)
    port_ests = fit_estimators(X, {k: port_ds.metrics[k] for k in KEYS}, n_quad=16, seed=0)
    for k in KEYS:
        # the port's numpy fits are copies: same family, same state, same predictions
        _assert_same_state(convert.state_of(ests[k]), convert.state_of(port_ests[k]))
        np.testing.assert_array_equal(ests[k].predict(X), _port(ests[k]).predict(X))
    yb = port_ds.metrics[KEYS[0]]
    assert rank_quadratic_terms(X, yb) == ref_rank(X, yb)


def test_surrogate_batch_matches_reference_estimators(fitted):
    ds, ests = fitted
    port_ests = {k: _port(v) for k, v in ests.items()}
    mb = float(ds.metrics[KEYS[0]].max())
    mp = float(ds.metrics[KEYS[1]].max())
    fn = fastchar.compile_surrogate_batch(port_ests, *KEYS, mb, mp, ctx=CPU)
    rng = np.random.default_rng(4)
    X = rng.integers(0, 2, (64, 10)).astype(np.float64)
    objs, viol = fn(X)
    assert objs.shape == (64, 2) and viol.shape == (64,)
    ref_b, ref_p = ests[KEYS[0]].predict(X), ests[KEYS[1]].predict(X)
    np.testing.assert_allclose(objs[:, 0], ref_b, atol=1e-4 * max(np.abs(ref_b).max(), 1.0))
    np.testing.assert_allclose(objs[:, 1], ref_p, atol=1e-4 * max(np.abs(ref_p).max(), 1.0))
    ref_viol = (np.maximum(0.0, ref_b - mb) / max(abs(mb), 1e-9)
                + np.maximum(0.0, ref_p - mp) / max(abs(mp), 1e-9))
    np.testing.assert_allclose(viol, ref_viol, atol=1e-5)
    assert (viol >= 0).all()


@pytest.mark.parametrize("family", ["poly", "gbt"])
def test_each_estimator_family_on_device(fitted, family):
    ds, _ = fitted
    X = ds.configs.astype(np.float64)
    y = ds.metrics[KEYS[1]]
    if family == "poly":
        model = ref_fit_poly(X, y, quad_pairs=ref_rank(X, y)[:8])
        pred = fastchar._poly_predict(_port(model), "cpu")
    else:
        model = RefGBT(n_trees=40, max_depth=4, seed=0).fit(X, y)
        pred = fastchar._gbt_predict(_port(model), "cpu")
    got = pred(torch.as_tensor(X, dtype=torch.float32)).numpy()
    want = model.predict(X)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(np.abs(want).max(), 1.0))


def test_map_values_match_quadexpr(fitted):
    ds, _ = fitted
    prob = _port(_problems(ds, 4, 1.0, [0.5])[0])
    cfgs = _all_configs(prob.n)
    obj, vb, vp = fastchar.map_problem_values(prob, cfgs, device="cpu")
    np.testing.assert_allclose(obj, prob.obj.value(cfgs), atol=1e-4)
    np.testing.assert_allclose(vb, prob.behav.value(cfgs), atol=1e-4)
    np.testing.assert_allclose(vp, prob.ppa.value(cfgs), atol=1e-4)
    res_np = miqcp.solve_enumerate(prob, pool_size=4, backend="numpy")
    res_t = miqcp.solve_enumerate(prob, pool_size=4, backend=CPU)
    assert abs(res_np.best_obj - res_t.best_obj) < 1e-4
    assert prob.feasible(res_t.pool).all()


def test_neighbor_values_match_flip_deltas(fitted):
    ds, _ = fitted
    probs = [_port(p) for p in _problems(ds, 4, 1.0, [0.25, 0.75])]
    rng = np.random.default_rng(5)
    states = rng.integers(0, 2, (len(probs), 3, probs[0].n)).astype(np.float64)
    vals, deltas = fastchar.tabu_neighbor_values_multi(probs, device="cpu")(states)
    for p, prob in enumerate(probs):
        v1, d1 = fastchar.tabu_neighbor_values(prob, device="cpu")(states[p])
        np.testing.assert_allclose(vals[p], v1, atol=1e-5)
        np.testing.assert_allclose(deltas[p], d1, atol=1e-5)
        for k, expr in enumerate((prob.obj, prob.behav, prob.ppa)):
            np.testing.assert_allclose(vals[p, k], expr.value(states[p]), atol=1e-4)
            for s in range(3):
                np.testing.assert_allclose(
                    deltas[p, k, s], expr.flip_deltas(states[p, s]), atol=1e-4)


def test_lockstep_tabu_finds_serial_numpy_best(fitted):
    """2 n_quad x 2 const_sf x 2 wt_B battery, as the reference's own test."""
    ds, _ = fitted
    ref_probs = []
    for n_quad in (0, 4):
        for const_sf in (0.5, 1.0):
            ref_probs.extend(_problems(ds, n_quad, const_sf, [0.25, 0.75]))
    probs = [_port(p) for p in ref_probs]
    seeds = list(range(len(probs)))
    multi = miqcp.solve_tabu_multi(probs, seeds=seeds, backend=CPU)
    singles = [miqcp.solve_tabu(p, seed=sd, backend=CPU) for p, sd in zip(probs[:2], seeds)]
    for k, (prob, ref_prob, sd, res) in enumerate(zip(probs, ref_probs, seeds, multi)):
        serial = ref_solve_tabu(ref_prob, seed=sd)  # the reference numpy oracle
        for got in [res] + singles[k:k + 1]:
            assert (serial.best is None) == (got.best is None)
            if serial.best is None:
                continue
            np.testing.assert_array_equal(serial.best, got.best)
            assert abs(got.best_obj - serial.best_obj) <= 1e-6 * (abs(serial.best_obj) + 1e-3)
            assert prob.feasible(got.pool).all()
            assert len(np.unique(got.pool, axis=0)) == len(got.pool)
            assert (got.pool == got.best).all(axis=1).any()


def test_port_problems_equal_reference_problems(fitted):
    ds, _ = fitted
    X = ds.configs.astype(float)
    yb, yp = ds.metrics[KEYS[0]], ds.metrics[KEYS[1]]
    bm = fit_poly(X, yb, quad_pairs=rank_quadratic_terms(X, yb)[:4])
    pm = fit_poly(X, yp, quad_pairs=rank_quadratic_terms(X, yp)[:4])
    ours = miqcp.build_problems(bm, pm, float(yb.max()), float(yp.max()), 0.5,
                                wt_grid=np.array([0.0, 0.5, 1.0]), n_quad=4)
    theirs = _problems(ds, 4, 0.5, [0.0, 0.5, 1.0])
    for a, b in zip(ours, theirs):
        _assert_same_state(convert.state_of(a), convert.state_of(b))
