"""The port's persistent DSE service: operator library, job queue, HTTP routes.

The counterpart of every test in ``tests/test_service.py``, run on the CPU,
plus the port's parity with the reference's library: the same content
addresses (``config_key``, ``request_key``, ``train_fingerprint``) for the
same inputs, and a library written by either package read back by the
other.  Every comparison is exact: keys are strings, records JSON, and an
empty library must leave ``run_dse``/``run_dse_sweep`` bit-identical to
``store=None``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.core.dataset import build_training_dataset as ref_build_training_dataset
from repro.core.dse import DSESettings as RefDSESettings
from repro.core.operator_model import spec_for as ref_spec_for
from repro.service import store as ref_store

from repro_torch import obs
from repro_torch.core.dataset import build_training_dataset, gen_random
from repro_torch.core.dse import DSESettings, fixed_library, run_dse, run_dse_sweep
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import spec_for
from repro_torch.obs.prom import MetricsServer, health_payload, render_prometheus
from repro_torch.service import (
    DSEJobQueue,
    DSERequest,
    OperatorStore,
    config_key,
    default_runner,
    request_key,
    store_status,
)
from repro_torch.service.store import SCHEMA_VERSION, train_fingerprint

CPU = ExecutionContext(device="cpu")
SPEC = spec_for(4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def store(tmp_path):
    return OperatorStore(root=str(tmp_path / "library"), tel=obs.Telemetry("svc-test"))


@pytest.fixture(scope="module")
def dse_setup():
    ds = build_training_dataset(SPEC, n_random=150, seed=0, backend=CPU)
    st = DSESettings(const_sf=0.8, pop_size=16, n_gen=6, seed=0, context=CPU)
    return ds, st


def _cpu_settings(**kw):
    return DSESettings(context=CPU, **kw)


# ---------------------------------------------------------------------------
# Content addressing, and parity with the reference's keys
# ---------------------------------------------------------------------------


class TestHashing:
    def test_key_is_order_and_type_stable(self):
        cfg = gen_random(SPEC, 1, seed=0)[0]
        k1 = config_key(SPEC, cfg, app="ecg", const_sf=0.5)
        k2 = config_key(SPEC, list(int(b) for b in cfg), app="ecg", const_sf=0.5)
        assert k1 == k2
        assert config_key(SPEC, cfg) != k1
        assert config_key(SPEC, cfg, app="ecg") != k1

    def test_key_stable_across_processes(self):
        """sha256 of canonical JSON: immune to hash randomization."""
        prog = (
            "import sys; sys.path.insert(0, 'src');"
            "from repro_torch.core.operator_model import spec_for;"
            "from repro_torch.service import config_key, request_key;"
            "import numpy as np;"
            "spec = spec_for(4);"
            "cfg = np.ones(spec.n_luts, np.uint8);"
            "print(config_key(spec, cfg, app='ecg'));"
            "print(request_key(spec, 'ecg', 0.5, 3, 'ga'))"
        )
        outs = set()
        for seed in ("0", "1", "4242"):
            env = dict(os.environ, PYTHONHASHSEED=seed)
            outs.add(subprocess.run(
                [sys.executable, "-c", prog], env=env, cwd=ROOT,
                capture_output=True, text=True, check=True,
            ).stdout)
        assert len(outs) == 1

    def test_request_key_separates_budget_and_data(self, dse_setup):
        ds, st = dse_setup
        fp = train_fingerprint(ds)
        base = request_key(SPEC, None, 0.8, 0, "ga", st, fp)
        assert base == request_key(SPEC, None, 0.8, 0, "ga", st, fp)
        st2 = _cpu_settings(const_sf=0.8, pop_size=32, n_gen=6)
        assert base != request_key(SPEC, None, 0.8, 0, "ga", st2, fp)
        assert base != request_key(SPEC, None, 0.8, 1, "ga", st, fp)
        assert base != request_key(SPEC, None, 0.8, 0, "ga", st, "other")

    @pytest.mark.parametrize("n_bits,signed,app,const_sf", [
        (4, True, None, None), (8, True, "ecg", 0.5), (8, False, "mnist", 1.2),
    ])
    def test_keys_equal_the_reference(self, n_bits, signed, app, const_sf):
        spec, rspec = spec_for(n_bits, signed=signed), ref_spec_for(n_bits, signed=signed)
        for cfg in gen_random(spec, 5, seed=n_bits):
            assert config_key(spec, cfg, app, const_sf) == \
                ref_store.config_key(rspec, cfg, app, const_sf)
        st = _cpu_settings(pop_size=64, n_gen=100, n_estimator_quad=32)
        rst = RefDSESettings(pop_size=64, n_gen=100, n_estimator_quad=32)
        for sf, seed, method in ((0.5, 0, "ga"), (1.5, 3, "map+ga")):
            assert request_key(spec, app, sf, seed, method, st, "fp") == \
                ref_store.request_key(rspec, app, sf, seed, method, rst, "fp")
            assert request_key(spec, app, sf, seed, method) == \
                ref_store.request_key(rspec, app, sf, seed, method)

    def test_train_fingerprint_equals_the_reference(self):
        """The same training set, built by each package's numpy oracle."""
        ds = build_training_dataset(SPEC, n_random=40, seed=3, backend="numpy")
        ref = ref_build_training_dataset(ref_spec_for(4), n_random=40, seed=3)
        assert train_fingerprint(ds) == ref_store.train_fingerprint(ref)


# ---------------------------------------------------------------------------
# Row/front round-trip, corruption tolerance, the reference's library
# ---------------------------------------------------------------------------


class TestStoreRoundTrip:
    def test_rows_round_trip_and_dedup(self, store):
        cfgs = gen_random(SPEC, 8, seed=1)
        objs = np.arange(16, dtype=np.float64).reshape(8, 2)
        assert store.put_rows(SPEC, cfgs, objs) == 8
        assert store.put_rows(SPEC, cfgs, objs) == 0
        again = OperatorStore(root=store.root, tel=store.tel)
        got, hit = again.lookup_rows(SPEC, cfgs)
        assert hit.all()
        np.testing.assert_array_equal(got, objs)
        assert store.tel.counter("service.store_hit") == 8

    def test_cached_characterize_skips_known_configs(self, store):
        cfgs = gen_random(SPEC, 6, seed=2)
        calls = []

        def fn(c):
            calls.append(len(c))
            return np.ones((len(c), 2))

        wrapped = store.cached_characterize(SPEC, fn)
        wrapped(cfgs)
        wrapped(cfgs)
        wrapped(gen_random(SPEC, 9, seed=3)[6:])
        assert calls == [6, 3]

    def test_front_round_trip_with_request_cache(self, store):
        cfgs = gen_random(SPEC, 4, seed=4)
        objs = np.random.default_rng(0).random((4, 2))
        store.put_front(SPEC, "ecg", 0.5, 7, "ga", cfgs, objs, hv_vpf=1.25,
                        n_evals=99, request="req-abc")
        again = OperatorStore(root=store.root, tel=store.tel)
        rec = again.lookup_result("req-abc")
        assert rec is not None and rec["hv"] == 1.25 and rec["seed"] == 7
        np.testing.assert_array_equal(np.asarray(rec["objs"]), objs)
        np.testing.assert_array_equal(again.warm_pool(SPEC, "ecg", 0.5), cfgs)

    def test_nearest_fronts_prefers_app_then_const_sf(self, store):
        c = gen_random(SPEC, 1, seed=5)
        o = np.ones((1, 2))
        store.put_front(SPEC, "ecg", 0.5, 0, "ga", c, o, 1.0)
        store.put_front(SPEC, None, 0.52, 0, "ga", c + 0, o, 1.0)
        store.put_front(SPEC, None, 0.9, 0, "ga", c + 0, o, 1.0)
        recs = store.nearest_fronts(SPEC, None, 0.5, k=3)
        assert [r["app"] for r in recs] == [None, None, "ecg"]
        assert recs[0]["const_sf"] == 0.52

    def test_corrupt_lines_warn_and_count_never_crash(self, store):
        cfgs = gen_random(SPEC, 3, seed=6)
        store.put_rows(SPEC, cfgs, np.ones((3, 2)))
        path = os.path.join(store.root, "rows.jsonl")
        with open(path, "a") as fh:
            fh.write("{not json}\n")
            fh.write(json.dumps({"schema": SCHEMA_VERSION + 99, "key": "x"}) + "\n")
            fh.write('{"schema": 1, "key": "truncat')
        tel = obs.Telemetry("svc-corrupt")
        with pytest.warns(UserWarning, match="corrupt"):
            again = OperatorStore(root=store.root, tel=tel)
            _, hit = again.lookup_rows(SPEC, cfgs)
        assert hit.all()
        assert tel.counter("service.store_corrupt") == 3

    def test_missing_library_reads_as_empty(self, tmp_path):
        store = OperatorStore(root=str(tmp_path / "nope"), tel=obs.Telemetry("svc-missing"))
        _, hit = store.lookup_rows(SPEC, gen_random(SPEC, 2, seed=0))
        assert not hit.any()
        assert store.warm_pool(SPEC, None, 0.5) is None

    def test_seed_fixed_library(self, store):
        st = _cpu_settings()
        n = store.seed_fixed_library(SPEC, settings=st)
        assert n == len(fixed_library(SPEC))
        assert store.seed_fixed_library(SPEC, settings=st) == 0
        assert store.warm_pool(SPEC, None, 0.5) is None

    def test_store_status_payload(self, store):
        store.put_rows(SPEC, gen_random(SPEC, 2, seed=7), np.ones((2, 2)))
        st = store_status(store)
        assert st["ok"] and st["rows"] == 2 and st["specs"] == ["mul4"]

    def test_library_written_by_the_reference_reads_back(self, tmp_path):
        """Rows and fronts the reference's store wrote answer the port's
        lookups, and the port's writes answer the reference's."""
        root = str(tmp_path / "shared")
        rspec = ref_spec_for(8)
        cfgs = gen_random(spec_for(8), 5, seed=8)
        objs = np.random.default_rng(8).random((5, 2))
        ref = ref_store.OperatorStore(root=root)
        ref.put_rows(rspec, cfgs, objs, app="mnist")
        ref.put_front(rspec, None, 0.5, 2, "map+ga", cfgs[:3], objs[:3], hv_vpf=3.5,
                      ppf_configs=cfgs, ppf_objs=objs, hv_ppf=4.0, n_evals=640,
                      request="req-ref")
        port = OperatorStore(root=root, tel=obs.Telemetry("svc-shared"))
        got, hit = port.lookup_rows(spec_for(8), cfgs, app="mnist")
        assert hit.all()
        np.testing.assert_array_equal(got, objs)
        rec = port.lookup_result("req-ref")
        assert rec["hv"] == 3.5 and rec["n_evals"] == 640 and rec["hv_ppf"] == 4.0
        np.testing.assert_array_equal(port.warm_pool(spec_for(8), None, 0.5), cfgs[:3])
        assert port.put_rows(spec_for(8), cfgs, objs[::-1].copy(), app="mnist") == 0
        new = gen_random(spec_for(8), 7, seed=9)[5:]
        assert port.put_rows(spec_for(8), new, np.ones((2, 2)), app="mnist") == 2
        back = ref_store.OperatorStore(root=root)
        assert back.stats()["rows"] == 7 and back.stats()["fronts"] == 1
        assert back.lookup_rows(rspec, new, app="mnist")[1].all()


# ---------------------------------------------------------------------------
# Cold-start bit-identity and warm-start behavior
# ---------------------------------------------------------------------------


class TestDSEIntegration:
    def test_empty_library_run_dse_bit_identical(self, dse_setup, store):
        ds, st = dse_setup
        base = run_dse(SPEC, ds, "ga", settings=st)
        cold = run_dse(SPEC, ds, "ga", settings=st, store=store)
        np.testing.assert_array_equal(base.ppf_configs, cold.ppf_configs)
        np.testing.assert_array_equal(base.vpf_configs, cold.vpf_configs)
        np.testing.assert_array_equal(base.vpf_objs, cold.vpf_objs)
        assert base.hv_vpf == cold.hv_vpf and base.hv_ppf == cold.hv_ppf

    def test_empty_library_sweep_bit_identical(self, dse_setup, tmp_path):
        ds, st = dse_setup
        grid = dict(seeds=(0, 1), const_sf_grid=(0.5, 0.8))
        base = run_dse_sweep(SPEC, ds, "ga", settings=st, **grid)
        cold = run_dse_sweep(
            SPEC, ds, "ga", settings=st,
            store=OperatorStore(root=str(tmp_path / "lib2"), tel=obs.Telemetry("svc-sweep")),
            **grid,
        )
        assert len(base) == len(cold) == 4
        for a, b in zip(base, cold):
            np.testing.assert_array_equal(a.vpf_configs, b.vpf_configs)
            np.testing.assert_array_equal(a.vpf_objs, b.vpf_objs)
            assert a.hv_vpf == b.hv_vpf

    def test_repeat_request_hits_cache_and_skips_search(self, dse_setup, store):
        ds, st = dse_setup
        first = run_dse(SPEC, ds, "ga", settings=st, store=store)
        again = run_dse(SPEC, ds, "ga", settings=st, store=store)
        assert store.tel.counter("service.request_hit") == 1
        assert "store" in again.timings and "ga" not in again.timings
        np.testing.assert_array_equal(first.vpf_configs, again.vpf_configs)
        np.testing.assert_array_equal(first.ppf_configs, again.ppf_configs)
        assert first.hv_vpf == again.hv_vpf

    def test_repeat_sweep_is_answered_from_the_library(self, dse_setup, store):
        ds, st = dse_setup
        grid = dict(seeds=(0, 1), const_sf_grid=(0.5, 0.8))
        first = run_dse_sweep(SPEC, ds, "ga", settings=st, store=store, **grid)
        again = run_dse_sweep(SPEC, ds, "ga", settings=st, store=store, **grid)
        assert store.tel.counter("service.request_hit") == 4
        for a, b in zip(first, again):
            assert "store" in b.timings and a.hv_vpf == b.hv_vpf
            np.testing.assert_array_equal(a.vpf_configs, b.vpf_configs)

    def test_validation_dedups_rows_on_second_run(self, dse_setup, store):
        ds, st = dse_setup
        run_dse(SPEC, ds, "ga", settings=st, store=store)
        hits0 = store.tel.counter("service.store_hit")
        run_dse(SPEC, ds, "ga", settings=dataclasses.replace(st, seed=9), store=store)
        assert store.tel.counter("service.store_hit") > hits0

    def test_warm_start_uses_library_and_does_not_hurt(self, dse_setup, store):
        ds, st = dse_setup
        run_dse(SPEC, ds, "ga", settings=st, store=store)
        st2 = dataclasses.replace(st, seed=11)
        cold = run_dse(SPEC, ds, "ga", settings=st2)
        warm = run_dse(SPEC, ds, "ga", settings=st2, store=store)
        assert warm.hv_vpf >= cold.hv_vpf * 0.98
        assert store.warm_pool(SPEC, None, st.const_sf) is not None

    def test_caller_characterize_fn_disables_store(self, dse_setup, store):
        ds, st = dse_setup
        fn = lambda c: np.ones((len(c), 2))  # noqa: E731
        run_dse(SPEC, ds, "ga", settings=st, characterize_fn=fn, store=store)
        assert store.stats()["rows"] == 0 and store.stats()["fronts"] == 0

    def test_telemetry_spans_cover_the_stages(self, dse_setup):
        ds, st = dse_setup
        tel = obs.Telemetry("svc-spans")
        run_dse(SPEC, ds, "map+ga", settings=st, telemetry=tel)
        run_dse_sweep(SPEC, ds, "ga", settings=st, seeds=(0, 1), telemetry=tel)
        names = [s.name for s in tel.spans]
        for name in ("dse.run", "dse.characterize", "dse.map", "dse.ga", "dse.validate",
                     "dse.sweep", "dse.lanes"):
            assert name in names, name
        trace = obs.chrome_trace_dict(tel)
        assert len(trace["traceEvents"]) == len(tel.spans)

    def test_jsonl_round_trip_and_profiler_ranges(self, tmp_path):
        """Spans, counters, gauges and histogram summaries export as JSONL
        and read back; ``annotate=True`` opens a profiler range a span."""
        tel = obs.Telemetry("svc-export", annotate=True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tel.span("dse.ga", n_lanes=3):
                with tel.span("dse.validate"):
                    tel.count("service.jobs", 2)
        tel.gauge("service.library_size", 5.0)
        tel.observe("service.batch_lanes", 12.0)
        path = tmp_path / "tel.jsonl"
        tel.to_jsonl(str(path))
        recs = obs.read_jsonl(str(path))
        spans = [r for r in recs if r["type"] == "span"]
        assert [r["name"] for r in spans] == ["dse.validate", "dse.ga"]
        assert spans[0]["parent_id"] == spans[1]["span_id"]
        assert {"type": "counter", "name": "service.jobs", "value": 2} in recs
        assert any(r["type"] == "histogram" and r["count"] == 1 for r in recs)
        keys = {e.key for e in prof.key_averages()}
        assert {"dse.ga", "dse.validate"} <= keys
        tel.to_chrome_trace(str(tmp_path / "trace.json"))
        trace = json.loads((tmp_path / "trace.json").read_text())
        assert trace["otherData"]["counters"] == {"service.jobs": 2}


# ---------------------------------------------------------------------------
# Job queue coalescing
# ---------------------------------------------------------------------------


class TestJobQueue:
    def test_coalesces_compatible_jobs_into_one_dispatch(self, store):
        tel = store.tel
        q = DSEJobQueue(default_runner(settings=_cpu_settings(pop_size=16, n_gen=4),
                                       store=store, n_train=100), tel=tel, linger_s=0.2)
        try:
            ids = [q.submit(DSERequest(n_bits=4, const_sf=sf, seed=s))
                   for sf in (0.5, 0.8) for s in (0, 1)]
            assert q.join(timeout=300)
            res = [q.result(i) for i in ids]
            assert all(r["status"] == "done" for r in res)
            assert tel.counter("service.jobs") == 4
            assert tel.counter("service.batches") == 1
            for (sf, s), r in zip([(sf, s) for sf in (0.5, 0.8) for s in (0, 1)], res):
                assert r["request"]["const_sf"] == sf and r["request"]["seed"] == s
                assert r["hv_vpf"] > 0
        finally:
            q.close()

    def test_incompatible_groups_dispatch_separately(self, store):
        tel = store.tel
        q = DSEJobQueue(default_runner(settings=_cpu_settings(pop_size=16, n_gen=4),
                                       store=store, n_train=100), tel=tel, linger_s=0.2)
        try:
            a = q.submit(DSERequest(n_bits=4, method="ga"))
            b = q.submit(DSERequest(n_bits=4, method="map+ga"))
            assert q.join(timeout=300)
            assert q.result(a)["status"] == "done"
            assert q.result(b)["status"] == "done"
            assert tel.counter("service.batches") == 2
        finally:
            q.close()

    def test_bad_request_yields_error_payload_not_crash(self, store):
        q = DSEJobQueue(default_runner(settings=_cpu_settings(pop_size=16, n_gen=8),
                                       store=store), tel=store.tel, linger_s=0.01)
        try:
            jid = q.submit(DSERequest(n_bits=4, op="bogus"))
            assert q.join(timeout=60)
            res = q.result(jid)
            assert res["status"] == "error" and "error" in res
            assert store.tel.counter("service.job_errors") == 1
        finally:
            q.close()

    def test_request_validation(self):
        with pytest.raises(ValueError, match="unknown request fields"):
            DSERequest.from_dict({"n_bits": 4, "bogus": 1})
        with pytest.raises(ValueError, match="method"):
            DSERequest.from_dict({"method": "map"})


# ---------------------------------------------------------------------------
# HTTP endpoint round-trip (MetricsServer routes)
# ---------------------------------------------------------------------------


class TestServeEndpoint:
    def test_post_get_round_trip(self, store):
        q = DSEJobQueue(default_runner(settings=_cpu_settings(pop_size=16, n_gen=4),
                                       store=store, n_train=100), tel=store.tel,
                        linger_s=0.05)
        srv = MetricsServer(port=0, check_device=False)
        srv.add_route("POST", "/dse", lambda p: {"job_id": q.submit(DSERequest.from_dict(p))})
        srv.add_route("GET", "/dse", lambda p: q.result(p["id"]) or {"status": "pending"})
        srv.add_route("GET", "/dse/library", lambda p: store_status(store))
        srv.start()
        try:
            body = json.dumps({"n_bits": 4, "const_sf": 0.5}).encode()
            req = urllib.request.Request(f"{srv.url}/dse", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as resp:
                jid = json.loads(resp.read())["job_id"]
            assert q.join(timeout=300)
            with urllib.request.urlopen(f"{srv.url}/dse?id={jid}") as resp:
                res = json.loads(resp.read())
            assert res["status"] == "done" and res["hv_vpf"] > 0
            with urllib.request.urlopen(f"{srv.url}/dse/library") as resp:
                lib = json.loads(resp.read())
            assert lib["ok"] and lib["rows"] > 0
        finally:
            q.close()
            srv.stop()

    def test_bad_post_body_is_400_unknown_route_404(self):
        srv = MetricsServer(port=0, check_device=False)
        srv.add_route("POST", "/dse", lambda p: DSERequest.from_dict(p) and {})
        srv.start()
        try:
            req = urllib.request.Request(f"{srv.url}/dse", data=b"{\"bogus\": 1}",
                                         headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(f"{srv.url}/nope", data=b"{}"))
            assert e.value.code == 404
        finally:
            srv.stop()

    def test_metrics_render_and_healthz_probes_the_card(self):
        """/metrics renders the counters, gauges and summaries; /healthz asks
        the card and answers 503 where none answers (as here on a host
        without one)."""
        tel = obs.Telemetry("svc-prom")
        tel.count("service.jobs", 3)
        tel.gauge("service.library_size", 12.0)
        for v in (1.0, 2.0, 4.0):
            tel.observe("service.batch_lanes", v)
        text = render_prometheus(tel)
        assert "repro_service_jobs_total 3" in text
        assert "repro_service_library_size 12.0" in text
        assert 'repro_service_batch_lanes{quantile="0.5"} 2.0' in text
        card = torch.cuda.is_available()
        assert health_payload(tel)["status"] == ("ok" if card else "degraded")
        srv = MetricsServer(tel=tel, port=0).start()
        try:
            with urllib.request.urlopen(f"{srv.url}/metrics") as resp:
                assert "repro_service_jobs_total 3" in resp.read().decode()
            if card:
                with urllib.request.urlopen(f"{srv.url}/healthz") as resp:
                    assert json.loads(resp.read())["device"]["kind"]
            else:
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(f"{srv.url}/healthz")
                assert e.value.code == 503
        finally:
            srv.stop()
