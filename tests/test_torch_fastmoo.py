"""Port device NSGA-II vs the reference: ranks, crowding, hypervolume, GA parity.

Deterministic building blocks must match the reference exactly (dominance
counts, constraint ranks) or to f32 rounding (crowding, hypervolume, 1e-5
relative).  Whole GA runs use torch's random streams, which differ from
numpy's, so they are held to the reference contract: feasible-archive
hypervolume within 2% of the numpy ``moo.nsga2``.
"""

import numpy as np
import pytest
import torch

from repro.core.moo import (
    crowding_distance as ref_crowding,
    fast_nondominated_sort,
    hypervolume_2d as ref_hypervolume_2d,
    nsga2 as ref_nsga2,
)

from repro_torch.core import fastmoo
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.moo import nsga2
from repro_torch.kernels import moo_kernels

CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are tiny: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_fastmoo():
    """The reference's device GA module (imports JAX, which the card's host lacks)."""
    pytest.importorskip("jax")
    from repro.core import fastmoo as ref

    return ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand_objs_viol(n, seed, infeas_p=0.4):
    rng = np.random.default_rng(seed)
    objs = rng.random((n, 2))
    viol = np.where(rng.random(n) < infeas_p, rng.random(n), 0.0)
    return objs, viol


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("pad", [0, 13])
@pytest.mark.parametrize("seed", [0, 1])
def test_dominance_counts_match_reference_matrix(ref_fastmoo, seed, pad):
    import jax.numpy as jnp

    n = 64
    objs, viol = _rand_objs_viol(n, seed)
    objs[::7] = objs[::5][: len(objs[::7])]  # duplicated points: ties in both axes
    rng = np.random.default_rng(seed + 10)
    active = rng.random(n) < 0.7
    dom = np.asarray(ref_fastmoo.dominance_matrix(
        jnp.asarray(objs, jnp.float32), jnp.asarray(viol, jnp.float32)))
    want = (dom & active[:, None]).sum(0)
    # pad rows: inactive, +inf violation -- never counted
    o = np.concatenate([objs, np.zeros((pad, 2))])
    v = np.concatenate([viol, np.full(pad, np.inf)])
    a = np.concatenate([active, np.zeros(pad, bool)])
    got = moo_kernels.dominance_counts(_t(o), _t(v), _t(a, torch.bool))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy()[:n], want)
    np.testing.assert_array_equal(
        moo_kernels.dominance_matrix(_t(objs), _t(viol)).numpy(), dom)


@pytest.mark.parametrize("impl", fastmoo.RANK_IMPLS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_constraint_ranks_match_oracle(seed, impl):
    objs, viol = _rand_objs_viol(48, seed)
    want = fast_nondominated_sort(objs, viol)
    got = fastmoo.constraint_ranks(_t(objs), _t(viol), impl=impl)
    np.testing.assert_array_equal(want, got.numpy())


def test_constraint_ranks_all_feasible_and_all_infeasible():
    objs, _ = _rand_objs_viol(32, 3, infeas_p=0.0)
    for viol in (np.zeros(32), 0.1 + np.random.default_rng(3).random(32)):
        want = fast_nondominated_sort(objs, viol)
        got = fastmoo.constraint_ranks(_t(objs), _t(viol))
        np.testing.assert_array_equal(want, got.numpy())


def _front_cases():
    """(name, objs, viol): random seeds 0-2, all feasible, all infeasible,
    duplicated points, one point, and a chain in which every point is its
    own front."""
    cases = [(f"seed{seed}", *_rand_objs_viol(48, seed)) for seed in range(3)]
    objs, _ = _rand_objs_viol(40, 5, infeas_p=0.0)
    cases.append(("all feasible", objs, np.zeros(40)))
    cases.append(("all infeasible", objs, 0.1 + np.random.default_rng(5).random(40)))
    dup, viol = _rand_objs_viol(40, 6, infeas_p=0.3)
    dup[20:] = dup[:20]            # every point twice, one copy's violation may differ
    cases.append(("duplicates", dup, viol))
    cases.append(("one point", np.array([[0.3, 0.7]]), np.zeros(1)))
    chain = np.linspace(0.0, 1.0, 33)[::-1]
    cases.append(("chain", np.stack([chain, chain], 1), np.zeros(33)))
    return cases


FRONT_CASES = _front_cases()


@pytest.mark.parametrize("name, objs, viol", FRONT_CASES, ids=[c[0] for c in FRONT_CASES])
def test_constraint_fronts_and_ranks_match_reference(ref_fastmoo, name, objs, viol):
    """K3's front peel (plain version; the wrapper on a CPU tensor) and the
    ranking built on it equal the reference's XLA ranking and the numpy
    oracle exactly."""
    import jax.numpy as jnp

    objs, viol = objs.astype(np.float32), viol.astype(np.float32)
    want = fast_nondominated_sort(objs, viol)
    ref = np.asarray(ref_fastmoo.constraint_ranks(jnp.asarray(objs), jnp.asarray(viol),
                                                  impl="xla"))
    np.testing.assert_array_equal(ref, want)
    feas = viol <= 0
    for fn in (moo_kernels.constraint_fronts_plain, moo_kernels.constraint_fronts):
        front, n_fronts = fn(_t(objs), _t(viol))
        assert front.dtype == torch.int64 and n_fronts.dtype == torch.int64
        assert n_fronts.shape == ()
        np.testing.assert_array_equal(front.numpy(), np.where(feas, want, -1))
        assert int(n_fronts) == (want[feas].max() + 1 if feas.any() else 0)
    for impl in fastmoo.RANK_IMPLS:
        got = fastmoo.constraint_ranks(_t(objs), _t(viol), impl=impl)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "chain":
        assert int(n_fronts) == len(objs)


@pytest.mark.parametrize("seed", [0, 1])
def test_crowding_matches_oracle_per_front(seed):
    objs, viol = _rand_objs_viol(40, seed)
    rank = fast_nondominated_sort(objs, viol)
    want = np.zeros(40)
    for r in np.unique(rank):
        idx = np.where(rank == r)[0]
        want[idx] = ref_crowding(objs[idx])
    got = fastmoo.crowding_distance(_t(objs), torch.as_tensor(rank)).numpy()
    np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(want[fin], got[fin], rtol=1e-5)


def test_crowding_constant_objective_column():
    objs = np.stack([np.linspace(0, 1, 6), np.full(6, 0.3)], axis=-1)
    want = ref_crowding(objs)
    got = fastmoo.crowding_distance(_t(objs), torch.zeros(6, dtype=torch.int64)).numpy()
    np.testing.assert_array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    np.testing.assert_allclose(want[fin], got[fin], rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hypervolume_matches_oracle_and_front_buffer(seed):
    objs, viol = _rand_objs_viol(60, seed, infeas_p=0.5)
    ref = np.array([1.2, 1.1])
    want = ref_hypervolume_2d(objs[viol <= 0], ref)
    got = float(fastmoo.hypervolume_2d(_t(objs), _t(viol <= 0, torch.bool), _t(ref)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # streamed front-buffer merges reach the same hypervolume
    buf_x = torch.full((64,), float("inf"))
    buf_y = torch.full((64,), float("inf"))
    for lo in range(0, 60, 20):
        buf_x, buf_y = fastmoo.front_update(
            buf_x, buf_y, _t(objs[lo:lo + 20]), _t(viol[lo:lo + 20]), _t(ref))
    np.testing.assert_allclose(float(fastmoo.front_hypervolume(buf_x, buf_y, _t(ref))),
                               want, rtol=1e-5)
    fin = torch.isfinite(buf_x)
    assert bool((buf_x[fin][1:] > buf_x[fin][:-1]).all())
    assert bool((buf_y[fin][1:] < buf_y[fin][:-1]).all())


def test_hypervolume_duplicates_and_empty():
    ref = _t([1.0, 1.0])
    pts = _t([[0.5, 0.5], [0.5, 0.5], [2.0, 2.0]])
    assert float(fastmoo.hypervolume_2d(pts, torch.ones(3, dtype=torch.bool), ref)) == 0.25
    assert float(fastmoo.hypervolume_2d(pts, torch.zeros(3, dtype=torch.bool), ref)) == 0.0


def _toy_objs_torch(X):
    a = X[:, :8].sum(dim=1)
    b = (1.0 - X[:, 8:]).sum(dim=1)
    return torch.stack([a, b], dim=-1)


def _toy_objs_np(pop):
    a = pop[:, :8].sum(axis=1).astype(float)
    b = (1 - pop[:, 8:]).sum(axis=1).astype(float)
    return np.stack([a, b], axis=-1)


@pytest.mark.parametrize("rank_impl", fastmoo.RANK_IMPLS)
def test_nsga2_toy_hypervolume_parity(rank_impl):
    ref = np.array([9.0, 9.0])
    r_np = ref_nsga2(_toy_objs_np, n_bits=16, pop_size=24, n_gen=30, seed=0, hv_ref=ref)
    r_t = fastmoo.nsga2_torch(_toy_objs_torch, n_bits=16, pop_size=24, n_gen=30, seed=0,
                              hv_ref=ref, rank_impl=rank_impl, ctx=CPU)
    assert r_t.archive_configs.shape == r_np.archive_configs.shape
    assert [n for n, _ in r_t.hv_history] == [n for n, _ in r_np.hv_history]
    hv_np, hv_t = r_np.hv_history[-1][1], r_t.hv_history[-1][1]
    assert abs(hv_t - hv_np) <= 0.02 * hv_np
    hvs = [h for _, h in r_t.hv_history]
    assert all(b >= a - 1e-6 for a, b in zip(hvs, hvs[1:]))


def test_nsga2_seeded_initial_population_is_used():
    init = np.zeros((4, 16), np.uint8)
    r = nsga2(None, n_bits=16, pop_size=8, n_gen=1, seed=0, backend=CPU,
              objs_device_fn=_toy_objs_torch, initial_population=init)
    assert (r.archive_configs[:8].sum(1) == 0).sum() >= 4


def test_nsga2_constraints_shape_archive_and_bad_args():
    r = nsga2(None, n_bits=16, pop_size=16, n_gen=5, seed=0, backend=CPU,
              objs_device_fn=_toy_objs_torch, max_behav=4.0, max_ppa=4.0)
    feas = r.archive_viol <= 0
    assert feas.any()
    assert (r.archive_objs[feas, 0] <= 4.0 + 1e-6).all()
    assert (r.archive_viol[r.archive_objs[:, 0] > 4.0 + 1e-6] > 0).all()
    with pytest.raises(ValueError):
        nsga2(_toy_objs_np, n_bits=16, backend=CPU)
    with pytest.raises(ValueError):
        fastmoo.CompiledNSGA2(_toy_objs_torch, n_bits=16, pop_size=7, ctx=CPU)
    with pytest.raises(ValueError, match="max_behav"):
        nsga2(None, n_bits=16, backend=CPU, objs_device_fn=_toy_objs_torch,
              violation_fn=lambda p: np.zeros(len(p)))


def test_nsga2_same_seed_same_run():
    kw = dict(n_bits=16, pop_size=16, n_gen=4, seed=3, hv_ref=np.array([9.0, 9.0]), ctx=CPU)
    a = fastmoo.nsga2_torch(_toy_objs_torch, **kw)
    b = fastmoo.nsga2_torch(_toy_objs_torch, **kw)
    np.testing.assert_array_equal(a.archive_configs, b.archive_configs)
    assert a.hv_history == b.hv_history


@pytest.mark.gpu
def test_dominance_kernel_matches_plain_on_card(cuda):
    for p in (64, 128, 1000):
        objs, viol = _rand_objs_viol(p, p)
        active = np.random.default_rng(p).random(p) < 0.7
        o, v, a = _t(objs), _t(viol), _t(active, torch.bool)
        before = moo_kernels.dominance_counts.launches
        got = moo_kernels.dominance_counts(o.to(cuda), v.to(cuda), a.to(cuda))
        torch.cuda.synchronize()
        assert moo_kernels.dominance_counts.launches == before + 1
        assert torch.equal(got.cpu(), moo_kernels.dominance_counts_plain(o, v, a))
        np.testing.assert_array_equal(
            fastmoo.constraint_ranks(o.to(cuda), v.to(cuda)).cpu().numpy(),
            fast_nondominated_sort(objs.astype(np.float32), viol.astype(np.float32)),
        )


@pytest.mark.gpu
@pytest.mark.parametrize("name, objs, viol", FRONT_CASES, ids=[c[0] for c in FRONT_CASES])
def test_constraint_fronts_kernel_matches_plain_on_card(cuda, name, objs, viol):
    o, v = _t(objs), _t(viol)
    before = moo_kernels.constraint_fronts.launches
    front, n_fronts = moo_kernels.constraint_fronts(o.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    assert moo_kernels.constraint_fronts.launches == before + 1
    want, n_want = moo_kernels.constraint_fronts_plain(o, v)
    assert torch.equal(front.cpu(), want) and int(n_fronts) == int(n_want)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [64, 128, 1000, 1024, 1025])
def test_constraint_fronts_sizes_on_card(cuda, p):
    """Up to FRONTS_MAX_P points one launch of the front peel; above, the
    round-by-round route through dominance_counts."""
    objs, viol = _rand_objs_viol(p, p)
    o, v = _t(objs), _t(viol)
    fronts0 = moo_kernels.constraint_fronts.launches
    counts0 = moo_kernels.dominance_counts.launches
    front, n_fronts = moo_kernels.constraint_fronts(o.to(cuda), v.to(cuda))
    torch.cuda.synchronize()
    want, n_want = moo_kernels.constraint_fronts_plain(o, v)
    assert torch.equal(front.cpu(), want) and int(n_fronts) == int(n_want)
    big = p > moo_kernels.FRONTS_MAX_P
    assert moo_kernels.constraint_fronts.launches == fronts0 + (not big)
    assert (moo_kernels.dominance_counts.launches > counts0) == big


@pytest.mark.gpu
def test_constraint_ranks_make_no_host_sync_on_card(cuda):
    objs, viol = _rand_objs_viol(128, 7)
    o, v = _t(objs).to(cuda), _t(viol).to(cuda)
    fastmoo.constraint_ranks(o, v)   # builds and loads the kernel outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rank = fastmoo.constraint_ranks(o, v)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(rank.cpu().numpy(), fast_nondominated_sort(
        objs.astype(np.float32), viol.astype(np.float32)))
