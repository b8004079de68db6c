"""The port's lane axis: K3 over lanes, ``CompiledNSGA2.run_sweep`` and ``run_dse_sweep``.

Lanes draw from their own generators in ``run``'s order and are evaluated at
``run``'s shape, so a lane must reproduce the single run at its seed, bounds
and seed pool: the same archive configs, objectives and hypervolume to 1e-6
relative (the reference's ``tests/test_fastmoo.py`` contract for its vmapped
sweep).  The ranking over lanes is held against the single-lane ranking and
the reference's numpy sort exactly; ``run_dse_sweep``'s lanes against
``run_dse`` (``hv_ppf`` to 1e-5 relative, the same validated front).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.moo import fast_nondominated_sort

from repro_torch.core import fastchar, fastmoo
from repro_torch.core.automl import fit_estimators
from repro_torch.core.dataset import BEHAV_KEY, PPA_KEY, build_training_dataset
from repro_torch.core.dse import DSESettings, map_solution_pool, run_dse, run_dse_sweep
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import spec_for
from repro_torch.kernels import moo_kernels

CPU = ExecutionContext(device="cpu")


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


def _lanes(n_lanes, p, seed, chain_lane=None):
    """(L, P, 2) objectives and (L, P) violations from numpy, ~40% infeasible;
    lane ``chain_lane`` is a chain in which every point is its own front."""
    rng = np.random.default_rng(seed)
    objs = rng.random((n_lanes, p, 2)).astype(np.float32)
    viol = np.where(rng.random((n_lanes, p)) < 0.4, rng.random((n_lanes, p)), 0.0)
    objs[:, ::7] = objs[:, ::5][:, : objs[:, ::7].shape[1]]   # duplicated points
    if chain_lane is not None:
        line = np.linspace(1.0, 0.0, p, dtype=np.float32)
        objs[chain_lane] = np.stack([line, line], 1)
        viol[chain_lane] = 0.0
    return torch.from_numpy(objs), torch.from_numpy(viol.astype(np.float32))


def _toy_objs(x):
    """The reference's toy objectives (``tests/test_fastmoo.py``) in torch."""
    return torch.stack([x[:, :8].sum(1), (1.0 - x[:, 8:]).sum(1)], dim=-1)


# ---------------------------------------------------------------------------
# K3 over lanes: the plain version and the batched ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_lanes,p", [(12, 128), (5, 100), (1, 64)])
def test_constraint_fronts_lanes_plain_matches_per_lane(n_lanes, p):
    objs, viol = _lanes(n_lanes, p, seed=p + n_lanes, chain_lane=n_lanes - 1)
    front, n_fronts = moo_kernels.constraint_fronts_lanes(objs, viol)   # CPU: plain
    want = moo_kernels.constraint_fronts_lanes_plain(objs, viol)
    assert torch.equal(front, want[0]) and torch.equal(n_fronts, want[1])
    assert front.shape == (n_lanes, p) and n_fronts.shape == (n_lanes,)
    for i in range(n_lanes):
        f, n = moo_kernels.constraint_fronts_plain(objs[i], viol[i])
        assert torch.equal(front[i], f) and int(n_fronts[i]) == int(n)
    assert int(n_fronts[-1]) == p   # the chain: one front a point


@pytest.mark.parametrize("n_lanes,p", [(12, 128), (5, 100)])
def test_constraint_ranks_lanes_match_single_lane_and_reference(n_lanes, p):
    objs, viol = _lanes(n_lanes, p, seed=3 * p)
    for impl in ("kernel", "plain"):
        ranks = fastmoo.constraint_ranks_lanes(objs, viol, impl=impl)
        for i in range(n_lanes):
            assert torch.equal(ranks[i], fastmoo.constraint_ranks(objs[i], viol[i], impl=impl))
            np.testing.assert_array_equal(
                ranks[i].numpy(), fast_nondominated_sort(objs[i].numpy(), viol[i].numpy()))


def test_crowding_distance_lanes_match_single_lane():
    objs, viol = _lanes(6, 128, seed=9)
    rank = fastmoo.constraint_ranks_lanes(objs, viol)
    crowd = fastmoo.crowding_distance_lanes(objs, rank)
    for i in range(6):
        assert torch.equal(crowd[i], fastmoo.crowding_distance(objs[i], rank[i]))


def test_constraint_fronts_lanes_checks_its_inputs():
    objs, viol = _lanes(3, 16, seed=1)
    with pytest.raises(ValueError, match="L, P"):
        moo_kernels.constraint_fronts_lanes(objs[0], viol[0])
    with pytest.raises(ValueError, match="L, P"):
        moo_kernels.constraint_fronts_lanes(objs, viol[:, :8])
    with pytest.raises(ValueError, match="float32"):
        moo_kernels.constraint_fronts_lanes(objs.double(), viol)
    with pytest.raises(ValueError, match="contiguous"):
        moo_kernels.constraint_fronts_lanes(objs.transpose(0, 1), viol.T)


# ---------------------------------------------------------------------------
# CompiledNSGA2.run_sweep: lanes vs single runs
# ---------------------------------------------------------------------------


def _assert_lane_equals_run(lane, single):
    np.testing.assert_array_equal(lane.archive_configs, single.archive_configs)
    np.testing.assert_array_equal(lane.population, single.population)
    np.testing.assert_allclose(lane.archive_objs, single.archive_objs, rtol=1e-6)
    np.testing.assert_allclose(lane.archive_viol, single.archive_viol, rtol=1e-6)
    assert [n for n, _ in lane.hv_history] == [n for n, _ in single.hv_history]
    np.testing.assert_allclose([h for _, h in lane.hv_history],
                               [h for _, h in single.hv_history], rtol=1e-6)


def test_run_sweep_lanes_match_single_runs_toy():
    runner = fastmoo.CompiledNSGA2(_toy_objs, n_bits=16, pop_size=16, n_gen=8,
                                   hv_ref=np.array([9.0, 9.0]), ctx=CPU)
    seeds = [0, 1, 0]
    bounds = [(1e30, 1e30), (1e30, 1e30), (5.0, 5.0)]
    lanes = runner.run_sweep(seeds, bounds)
    assert len(lanes) == 3
    for seed, (mb, mp), lane in zip(seeds, bounds, lanes):
        _assert_lane_equals_run(lane, runner.run(seed=seed, max_behav=mb, max_ppa=mp))
    assert runner.run_sweep([], []) == []


@pytest.fixture(scope="module")
def surrogate8():
    """The fitted 8-bit surrogate of the reference's GA tests (150 random
    configs, n_quad=16), characterized on the CPU."""
    spec = spec_for(8)
    ds = build_training_dataset(spec, n_random=150, seed=0, backend=CPU)
    ests = fit_estimators(
        ds.configs.astype(np.float64),
        {BEHAV_KEY: ds.metrics[BEHAV_KEY], PPA_KEY: ds.metrics[PPA_KEY]},
        n_quad=16, seed=0,
    )
    return spec, ds, ests


def test_run_sweep_lanes_match_single_runs_surrogate(surrogate8):
    """On the 8-bit surrogate, with per-lane seed pools (an array, a tuple of
    two pools, None), constraint bounds that leave infeasible points, and
    the plain ranking as well."""
    spec, ds, ests = surrogate8
    mb = float(ds.metrics[BEHAV_KEY].max())
    mp = float(ds.metrics[PPA_KEY].max())
    fn = fastchar.surrogate_objs_device(ests, BEHAV_KEY, PPA_KEY, "cpu")
    pool = ds.configs[:10]
    seeds = [0, 1, 0]
    bounds = [(mb, mp), (0.5 * mb, 0.5 * mp), (0.2 * mb, 0.8 * mp)]
    pools = [pool, (pool[:3], ds.configs[20:25]), None]
    for impl in ("kernel", "plain"):
        runner = fastmoo.CompiledNSGA2(fn, n_bits=spec.n_luts, pop_size=32, n_gen=12,
                                       hv_ref=np.array([1.05 * mb, 1.05 * mp]),
                                       rank_impl=impl, ctx=CPU)
        lanes = runner.run_sweep(seeds, bounds, pools)
        for seed, (b, p), init, lane in zip(seeds, bounds, pools, lanes):
            _assert_lane_equals_run(lane, runner.run(seed, b, p, init))
        assert (lanes[2].archive_viol > 0).any()


# ---------------------------------------------------------------------------
# run_dse_sweep: lane order, lanes vs run_dse
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dse4():
    spec = spec_for(4)
    ds = build_training_dataset(spec, n_random=150, seed=0, backend=CPU)
    st = DSESettings(pop_size=16, n_gen=6, n_quad_grid=(0, 4), pool_size=2, seed=0,
                     context=CPU)
    return spec, ds, st


@pytest.mark.parametrize("method", ["ga", "map+ga"])
def test_run_dse_sweep_lane_order_and_lanes_match_run_dse(dse4, method):
    """Lane order ``for const_sf: for seed``; a lane equals ``run_dse`` at
    its (seed, const_sf) with the sweep's estimators and MaP pool (fitted
    once, and solved once per const_sf, at the settings' seed, as the
    reference's sweep does)."""
    spec, ds, st = dse4
    ests = fit_estimators(
        ds.configs.astype(np.float64),
        {BEHAV_KEY: ds.metrics[BEHAV_KEY], PPA_KEY: ds.metrics[PPA_KEY]},
        n_quad=st.n_estimator_quad, seed=st.seed,
    )
    results = run_dse_sweep(spec, ds, method, settings=st, seeds=(0, 1),
                            const_sf_grid=(0.5, 1.5))
    assert [r.settings.const_sf for r in results] == [0.5, 0.5, 1.5, 1.5]
    assert [r.settings.seed for r in results] == [0, 1, 0, 1]
    pools = {}
    for r in results:
        assert r.n_evals == 16 * 7
        assert set(r.timings) >= {"characterize", "ga", "validate"}
        lane_st = dataclasses.replace(st, const_sf=r.settings.const_sf, seed=r.settings.seed)
        pool = None
        if method == "map+ga":
            sf = r.settings.const_sf
            if sf not in pools:
                pools[sf] = map_solution_pool(spec, ds, dataclasses.replace(st, const_sf=sf))
            pool = pools[sf]
        single = run_dse(spec, ds, method, settings=lane_st, estimators=ests, map_pool=pool)
        np.testing.assert_allclose(r.hv_ppf, single.hv_ppf, rtol=1e-5)
        np.testing.assert_array_equal(r.vpf_configs, single.vpf_configs)
        np.testing.assert_array_equal(r.vpf_objs, single.vpf_objs)
        assert r.hv_vpf == single.hv_vpf


def test_run_dse_sweep_refuses_numpy_and_unknown_methods(dse4):
    spec, ds, st = dse4
    with pytest.raises(ValueError, match="torch backend"):
        run_dse_sweep(spec, ds, "ga",
                      settings=DSESettings(context=ExecutionContext(backend="numpy")))
    with pytest.raises(ValueError, match="unsupported sweep method"):
        run_dse_sweep(spec, ds, "map", settings=st)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("n_lanes,p", [(12, 128), (5, 100), (3, 1024)])
def test_constraint_fronts_lanes_kernel_matches_plain_on_card(cuda, n_lanes, p):
    """One launch for every lane, equal to the plain version lane by lane."""
    objs, viol = _lanes(n_lanes, p, seed=p, chain_lane=0)
    before = moo_kernels.constraint_fronts_lanes.launches
    single = moo_kernels.constraint_fronts.launches
    front, n_fronts = moo_kernels.constraint_fronts_lanes(objs.to(cuda), viol.to(cuda))
    torch.cuda.synchronize()
    assert moo_kernels.constraint_fronts_lanes.launches == before + 1
    assert moo_kernels.constraint_fronts.launches == single
    want, n_want = moo_kernels.constraint_fronts_lanes_plain(objs, viol)
    assert torch.equal(front.cpu(), want) and torch.equal(n_fronts.cpu(), n_want)


@pytest.mark.gpu
def test_constraint_fronts_lanes_refuses_large_populations_on_card(cuda):
    objs, viol = _lanes(2, moo_kernels.FRONTS_MAX_P + 1, seed=5)
    with pytest.raises(ValueError, match="P <="):
        moo_kernels.constraint_fronts_lanes(objs.to(cuda), viol.to(cuda))


@pytest.mark.gpu
def test_run_sweep_ranks_every_lane_in_one_launch_on_card(cuda):
    """Two rankings a generation, one K3 launch each for all lanes and none
    a lane; each lane equals its single run on the card."""
    ctx = ExecutionContext()
    runner = fastmoo.CompiledNSGA2(_toy_objs, n_bits=16, pop_size=32, n_gen=10,
                                   hv_ref=np.array([9.0, 9.0]), ctx=ctx)
    seeds, bounds = [0, 1, 2, 0], [(1e30, 1e30)] * 3 + [(5.0, 5.0)]
    lanes0 = moo_kernels.constraint_fronts_lanes.launches
    single0 = moo_kernels.constraint_fronts.launches
    lanes = runner.run_sweep(seeds, bounds)
    assert moo_kernels.constraint_fronts_lanes.launches == lanes0 + 2 * 10
    assert moo_kernels.constraint_fronts.launches == single0
    for seed, (mb, mp), lane in zip(seeds, bounds, lanes):
        _assert_lane_equals_run(lane, runner.run(seed, mb, mp))
