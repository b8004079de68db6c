"""The port's tile autotuner: policies, the on-disk cache, parity gating.

Counterpart of ``tests/test_tuning.py``.  ``"off"`` never touches the cache;
``"cached"`` searches once, then hits, and round-trips the disk; a corrupt
cache warns, counts and re-tunes; ``"search"`` ignores the disk but memoizes
in the process; every record is parity-gated against the plain version;
tuned tiles give the untuned results (int channels bit for bit, the f32
channel to 1e-6 relative, as the reference's test holds them); the engine
entry points accept a tuned context.  On the CPU the search times the plain
versions (the reference times interpret mode); the cache is keyed by device.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import spec_for
from repro_torch.kernels import registry, tuning
from repro_torch.obs import telemetry as obs

CTX = ExecutionContext(device="cpu", tuning="cached")
SHAPE = dict(n_bits=4, d=40)          # fastchar's bucket (4, 64)


@pytest.fixture()
def cache_env(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path))
    tuning.reset_stats()
    yield tmp_path
    tuning.reset_stats()


def _cache_files(path):
    return [f for f in os.listdir(path) if f.endswith(".json")]


def test_off_policy_never_touches_the_cache(cache_env):
    for ctx in (None, ExecutionContext(device="cpu")):
        tiles = tuning.tiles_for(ctx, "fastchar.table", **SHAPE)
        assert tiles == {"a_tile": 16}
    assert tuning.STATS["searches"] == 0
    assert not _cache_files(cache_env)
    assert tuning.launch_overrides(None, "axo_matmul.kernel", m=4, k=64, n=128, rank=8) == {}


def test_cached_policy_searches_once_then_hits(cache_env):
    tiles1 = tuning.tiles_for(CTX, "fastchar.table", **SHAPE)
    assert tuning.STATS["searches"] == 1
    assert len(_cache_files(cache_env)) == 1
    # the same bucket (d=50 buckets to 64 too): no search
    assert tuning.tiles_for(CTX, "fastchar.table", n_bits=4, d=50) == tiles1
    assert tuning.STATS["searches"] == 1


def test_second_run_round_trips_the_disk_cache(cache_env):
    tiles1 = tuning.tiles_for(CTX, "fastchar.entry", **SHAPE)
    tuning.reset_stats()        # a fresh process: only the disk survives
    assert tuning.tiles_for(CTX, "fastchar.entry", **SHAPE) == tiles1
    assert tuning.STATS["searches"] == 0
    assert tuning.STATS["cache_hits"] == 1
    path = os.path.join(cache_env, _cache_files(cache_env)[0])
    with open(path) as f:
        data = json.load(f)
    (key,) = data
    assert key.startswith("fastchar.entry|") and tuning.device_key("cpu") in key
    assert key.endswith("|4x64")
    rec = data[key]
    assert rec["tiles"] == tiles1 and rec["candidates"] == 4 and rec["rejected"] == 0
    assert len(rec["timings"]) == 4 and rec["default"]["tiles"] == {"a_tile": 16, "configs": 1}


def test_corrupt_cache_warns_counts_and_retunes(cache_env, caplog):
    tuning.tiles_for(CTX, "fastchar.table", **SHAPE)
    path = os.path.join(cache_env, _cache_files(cache_env)[0])
    with open(path, "w") as f:
        f.write("{not json")
    tuning.reset_stats()
    with caplog.at_level(logging.WARNING, logger="repro_torch.kernels.tuning"):
        tuning.tiles_for(CTX, "fastchar.table", **SHAPE)
    assert any("unreadable" in r.message for r in caplog.records)
    assert obs.GLOBAL.counter("tuning.cache_corrupt") == 1
    assert tuning.STATS["searches"] == 1
    with open(path) as f:
        assert json.load(f)          # rewritten whole


def test_search_policy_ignores_disk_but_memoizes_in_process(cache_env):
    tuning.tiles_for(CTX, "fastchar.table", **SHAPE)
    search = ExecutionContext(device="cpu", tuning="search")
    tuning.tiles_for(search, "fastchar.table", **SHAPE)
    tuning.tiles_for(search, "fastchar.table", **SHAPE)
    assert tuning.STATS["searches"] == 2 and tuning.STATS["cache_hits"] == 0
    tuning.reset_stats()
    tuning.tiles_for(search, "fastchar.table", **SHAPE)
    assert tuning.STATS["searches"] == 1


def test_stats_view_tracks_telemetry_counters(cache_env):
    assert dict(tuning.STATS) == {"searches": 0, "cache_hits": 0, "candidates_timed": 0}
    obs.GLOBAL.count("tuning.search", 2)
    assert tuning.STATS["searches"] == 2
    with pytest.raises(TypeError):
        del tuning.STATS["searches"]


@pytest.mark.parametrize("name,shape", [
    ("fastchar.table", dict(n_bits=8, d=12)),
    ("fastchar.entry", dict(n_bits=8, d=12)),
    ("fastapp.table", dict(n_bits=4, d=3, m=40, k=72, n=6)),
    ("axo_matmul.kernel", dict(m=24, k=192, n=160, rank=8)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_search_records_are_parity_gated(cache_env, name, shape):
    spec = registry.get(name)
    rec = tuning.autotune(spec, "cpu", **shape)
    assert rec["candidates"] == len(spec.candidates(**shape)) > 1
    assert rec["rejected"] == 0 and len(rec["timings"]) == rec["candidates"]
    assert rec["tiles"] in spec.candidates(**shape)
    assert rec["default"]["tiles"] == spec.default_tiles(**shape)
    assert rec["default"]["us"] > 0
    for tiles in spec.candidates(**shape):
        assert tuning.parity_ok(spec, tiles, "cpu", **shape)


@pytest.mark.parametrize("name,shape", [
    ("fastapp.table", dict(n_bits=4, d=3, m=40, k=72, n=6)),
    ("axo_matmul.kernel", dict(m=24, k=192, n=160, rank=8)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_search_leaves_once_a_shape_bookkeeping_alone(cache_env, name, shape):
    """The search's probes and candidate launches are no path's: they move no
    ``jit.retrace.*`` counter and no ``*.pad_waste`` record, on the current
    telemetry or on GLOBAL."""
    tel = obs.Telemetry("t", parent=obs.GLOBAL)

    def marks(t):
        return ({k: v for k, v in t.counters.items() if k.startswith("jit.retrace.")},
                {k: len(v) for k, v in t.histograms.items() if k.endswith(".pad_waste")})

    before = marks(obs.GLOBAL)
    with obs.use(tel):
        rec = tuning.autotune(registry.get(name), "cpu", **shape)
        assert all(tuning.parity_ok(registry.get(name), t, "cpu", **shape)
                   for t in registry.get(name).candidates(**shape))
    assert rec["candidates"] > 1 and tel.counter("tuning.search") == 1
    assert marks(tel) == ({}, {}) and marks(obs.GLOBAL) == before


def test_a_candidate_that_breaks_parity_is_rejected(cache_env, monkeypatch):
    """The gate is real: a wrapper that is wrong at one tile loses that tile
    and keeps the defaults where every tile is wrong."""
    make, run, oracle, channels = tuning._HARNESS["fastchar"]

    def wrong_at_8(spec, case, tiles):
        i, r = run(spec, case, tiles)
        return (i + 1, r) if tiles["a_tile"] == 8 else (i, r)

    monkeypatch.setitem(tuning._HARNESS, "fastchar", (make, wrong_at_8, oracle, channels))
    spec = registry.get("fastchar.table")
    rec = tuning.autotune(spec, "cpu", n_bits=4, d=16)
    assert rec["rejected"] == 1 and rec["rejected_tiles"] == [{"a_tile": 8}]
    assert rec["tiles"] == {"a_tile": 16}


def test_cached_tiles_give_the_untuned_results(cache_env):
    from repro_torch.core.fastchar import behav_metrics_torch

    spec = spec_for(8)
    rng = np.random.default_rng(3)
    cfgs = rng.integers(0, 2, (24, spec.n_luts)).astype(np.uint8)
    for impl in ("table", "entry"):
        base = behav_metrics_torch(spec, cfgs, impl=impl, ctx=ExecutionContext(device="cpu"))
        tuned = behav_metrics_torch(spec, cfgs, impl=impl, ctx=CTX)
        for k in base:
            if k == "AVG_ABS_REL_ERR":
                np.testing.assert_allclose(tuned[k], base[k], rtol=1e-6)
            else:
                np.testing.assert_array_equal(tuned[k], base[k], err_msg=k)
    assert tuning.STATS["searches"] == 2


def test_engine_entry_points_accept_a_tuned_context(cache_env):
    from repro_torch.apps.fastapp import table_batch, table_matmul_torch
    from repro_torch.axo.deploy import AxOOperator, axo_linear
    from repro_torch.core import dse
    from repro_torch.core.dataset import build_training_dataset

    spec4 = spec_for(4)
    ctx = ExecutionContext(device="cpu", tuning="cached", telemetry="on")
    rng = np.random.default_rng(5)
    # fastapp: K4's tiles
    cfgs = rng.integers(0, 2, (3, spec4.n_luts)).astype(np.uint8)
    a = rng.integers(0, 16, (20, 30)).astype(np.int32)
    b = rng.integers(0, 16, (30, 5)).astype(np.int32)
    want = table_matmul_torch(table_batch(spec4, cfgs, ExecutionContext(device="cpu")), a, b)
    assert torch.equal(table_matmul_torch(table_batch(spec4, cfgs, ctx), a, b), want)
    # the AxO linear: K6's splits
    op = AxOOperator.from_config(rng.integers(0, 2, spec_for(8).n_luts).astype(np.uint8))
    x = torch.from_numpy(rng.standard_normal((6, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32))
    assert torch.equal(axo_linear(x, w, op, ctx=ctx),
                       axo_linear(x, w, op, ctx=ExecutionContext(device="cpu")))
    # a small run_dse under the tuned context matches the untuned one
    ds = build_training_dataset(spec4, n_random=60, seed=0, backend=ExecutionContext(device="cpu"))
    st = dict(pop_size=8, n_gen=3, n_quad_grid=(0,), pool_size=2, seed=0)
    runs = [dse.run_dse(spec4, ds, "map+ga", settings=dse.DSESettings(context=c, **st))
            for c in (ExecutionContext(device="cpu"), ctx)]
    np.testing.assert_array_equal(runs[0].vpf_configs, runs[1].vpf_configs)
    np.testing.assert_allclose(runs[0].vpf_objs, runs[1].vpf_objs, rtol=1e-6)
    tel = ctx.telemetry
    for name in ("dispatch.fastapp.table", "dispatch.axo_linear.kernel",
                 "dispatch.fastchar.table", "dispatch.fastmoo.run",
                 "registry.dispatch.fastchar.table", "registry.dispatch.axo_matmul.kernel"):
        assert tel.counter(name) >= 1, name
    assert tuning.STATS["searches"] >= 3


def test_cache_status_never_raises(cache_env, monkeypatch):
    status = tuning.cache_status()
    assert status["ok"] and status["entries"] == 0 and not status["exists"]
    tuning.tiles_for(CTX, "fastchar.table", **SHAPE)
    status = tuning.cache_status(tuning.default_cache("cpu"))
    assert status["ok"] and status["exists"] and status["entries"] == 1
    assert status["searches"] == 1 and status["misses"] == 1

    def broken(device=None):
        raise RuntimeError("no device")

    monkeypatch.setattr(tuning, "default_cache", broken)
    assert tuning.cache_status() == {"ok": False, "error": "RuntimeError: no device"}


def test_device_key_names_the_device():
    assert tuning.device_key("cpu").startswith("cpu:")
    assert tuning.default_cache("cpu").path.endswith(
        tuning.device_key("cpu").replace(":", "_") + ".json")
    if torch.cuda.is_available():
        assert tuning.device_key("cuda").startswith("cuda:")
