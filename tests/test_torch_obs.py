"""The port's observability: once-per-shape counters, pad waste, device taps,
the tapped GA's per-generation curve, profiling and ``serve.py --trace``.

Counterpart of ``tests/test_obs.py`` (its tap, GA-curve and note_trace
parts).  The port traces nothing, so ``note_trace`` counts the work done
once per shape (a plan cache miss), never once per call; the GA's tap stages
rows on the device and ``run`` drains them, so the assertions are the
reference's ``test_tapped_nsga2_per_generation_hv_curve``'s: one row a
generation, a monotone hv, the last hv equal to ``hv_history[-1]`` to 1e-6
relative and to the reference's numpy ``moo.hypervolume_2d`` on the port's
own archive, ``hv_history`` bitwise equal tapped and untapped.
"""

import json

import numpy as np
import pytest
import torch

from repro.core.moo import hypervolume_2d as ref_hypervolume_2d

from repro_torch.core.engine import ExecutionContext
from repro_torch.core.fastmoo import CompiledNSGA2
from repro_torch.kernels import app_kernels, axo_matmul, flash_attention
from repro_torch.obs import device as obs_device
from repro_torch.obs import telemetry as tm
from repro_torch.obs.profile import (
    DIVERGENCE_RATIO,
    check_estimate,
    profile_fn,
    profile_registry,
    trace_capture,
)

REF = np.array([9.0, 9.0])


def test_note_trace_counts_once_per_shape_work_not_calls():
    tel = tm.Telemetry("t")
    tables = torch.zeros((1, 256), dtype=torch.int32)       # 4-bit product tables
    a = torch.zeros((8, 16), dtype=torch.int32)
    b = torch.zeros((16, 4), dtype=torch.int32)
    with tm.use(tel):
        for _ in range(3):
            app_kernels.table_gemv(tables, a, b, route="gather")
            axo_matmul.axo_matmul(*_k6_args(4, 64, 40))
        assert tel.counter("jit.retrace.app_kernels.plan") == 1
        assert tel.counter("jit.retrace.axo_matmul.plan") == 1
        app_kernels.table_gemv(tables, a[:5], b, route="gather")   # a new shape: one more
        assert tel.counter("jit.retrace.app_kernels.plan") == 2
        # planning alone, as the registry's probes plan, records nothing
        app_kernels.plan(96, 64, 128, 8)
        axo_matmul.plan(24, 128, 64, 8, 256)
        assert tel.counter("jit.retrace.app_kernels.plan") == 2
        assert tel.counter("jit.retrace.axo_matmul.plan") == 1
    # a later telemetry sees the shapes it launches once more
    later = tm.Telemetry("later")
    with tm.use(later):
        axo_matmul.axo_matmul(*_k6_args(4, 64, 40))
    assert later.counter("jit.retrace.axo_matmul.plan") == 1
    assert later.histogram_summary("axo_matmul.pad_waste")["count"] == 1
    tm.note_trace("x")
    assert tm.GLOBAL.counter("jit.retrace.x") >= 1


def _k6_args(m, k, n, rank=2, seed=0):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8))
    f = torch.from_numpy(rng.standard_normal((256, rank)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((256, rank)).astype(np.float32))
    sv = torch.arange(256, dtype=torch.float32) - 128
    return a, b, f, g, sv


def test_pad_waste_of_a_k6_and_a_k7_call():
    tel = tm.Telemetry("t")
    with tm.use(tel):
        # deepseek-v3's 24-row expert buffer on the skinny route's 24-row,
        # 128-column block: no waste; on route 1's 128-row tile 1 - 24/128
        axo_matmul.axo_matmul(*_k6_args(24, 64, 128))
        assert tel.gauges["axo_matmul.pad_waste"] == 0.0
        axo_matmul.axo_matmul(*_k6_args(24, 64, 128), route="mma")
        assert tel.gauges["axo_matmul.pad_waste"] == pytest.approx(1 - 24 / 128)
        # the GEMV route: M=4 rows on a 4-row group, N=40 of a 512-column block,
        # K=48 of two 32-code steps
        axo_matmul.axo_matmul(*_k6_args(4, 48, 40))
        assert tel.gauges["axo_matmul.pad_waste"] == pytest.approx(
            1 - (4 * 40 * 48) / (4 * 512 * 64))
        assert tel.histogram_summary("axo_matmul.pad_waste")["count"] == 3
        # K7: Sq = 37 queries and 37 keys on 64 x 64 tiles; once a shape
        q = torch.randn(1, 2, 37, 16)
        kv = torch.randn(1, 1, 37, 16)
        for _ in range(2):
            flash_attention.flash_attention(q, kv, kv)
        assert tel.gauges["flash_attention.pad_waste"] == pytest.approx(1 - 37 * 37 / 64**2)
        assert tel.histogram_summary("flash_attention.pad_waste")["count"] == 1


def test_null_telemetry_records_nothing():
    tel = tm.NULL
    with tel.span("x", a=1):
        tel.count("c")
        tel.gauge("g", 1.0)
        tel.emit("s", {"v": 1})
        tel.set_counter("c", 3)
    assert tel.device_tap("t", ("x",)) is obs_device.null_tap
    assert tel.device_batched_tap("t", ("x",)) is obs_device.null_tap
    assert obs_device.null_tap(torch.ones(2)) is None
    assert not tel.counters and not tel.gauges and not tel.series and not tel.spans
    assert not tel.device_taps and tm.as_telemetry("on").device_taps


def test_taps_stage_rows_and_drain_at_flush():
    tel = tm.Telemetry("t")
    tap = tel.device_tap("loop", ("i", "x"))
    for i in range(4):
        tap(torch.tensor(float(i)), i * 2)
    with pytest.raises(TypeError):
        tap(1.0)
    chunk = tel.device_batched_tap("chunk", ("g", "v"))
    rows = torch.tensor([[0.0, 10.0], [1.0, 11.0], [-1.0, 0.0]])
    chunk(rows, rows[:, 0] >= 0)
    with pytest.raises(TypeError):
        chunk(rows[:, :1], rows[:, 0] >= 0)
    obs_device.flush()
    assert [int(r["i"]) for r in tel.series["loop"]] == [0, 1, 2, 3]
    assert [float(r["x"]) for r in tel.series["loop"]] == [0.0, 2.0, 4.0, 6.0]
    assert [(int(r["g"]), float(r["v"])) for r in tel.series["chunk"]] == [(0, 10.0), (1, 11.0)]
    assert tel.counter("tap.loop") == 4 and tel.counter("tap.chunk") == 2
    assert all("_host_t" in r for r in tel.series["loop"] + tel.series["chunk"])


def _toy_objs(X):
    a = X[:, :8].sum(1)
    b = (1.0 - X[:, 8:]).sum(1)
    return torch.stack([a, b], dim=-1)


def _constrained_objs(X):
    """A toy whose bound max_behav=3 leaves part of each population infeasible."""
    return torch.stack([X[:, :8].sum(1), (1.0 - X[:, 8:]).sum(1) + 0.5 * X[:, 0]], dim=-1)


def test_tapped_nsga2_per_generation_hv_curve():
    ctx = ExecutionContext(device="cpu", telemetry="on")
    runner = CompiledNSGA2(_toy_objs, n_bits=16, pop_size=16, n_gen=10, hv_ref=REF, ctx=ctx)
    assert runner._tapped
    r = runner.run(seed=0)
    tel = ctx.telemetry
    taps = tel.series["fastmoo.gen"]
    assert len(taps) == 10
    assert [int(t["gen"]) for t in taps] == list(range(10))
    hvs = [float(t["hv"]) for t in taps]
    assert all(b >= a for a, b in zip(hvs, hvs[1:]))
    assert np.isclose(hvs[-1], r.hv_history[-1][1], rtol=1e-6)
    assert all(float(t["pop_feas"]) == 1.0 for t in taps)     # unconstrained
    assert all(int(t["arc_feasible"]) > 0 for t in taps)
    fronts = [int(t["front"]) for t in taps]
    assert all(0 < f <= runner.front_capacity for f in fronts)
    assert runner.front_capacity == 64

    runner.run(seed=1)                 # a second run adds n_gen rows
    assert len(tel.series["fastmoo.gen"]) == 20
    assert tel.counter("dispatch.fastmoo.run") == 2
    assert tel.counter("tap.fastmoo.gen") == 20

    plain = CompiledNSGA2(_toy_objs, n_bits=16, pop_size=16, n_gen=10, hv_ref=REF,
                          ctx=ExecutionContext(device="cpu"))
    assert not plain._tapped
    r_plain = plain.run(seed=0)
    assert [h for _, h in r.hv_history] == [h for _, h in r_plain.hv_history]
    np.testing.assert_array_equal(r.archive_configs, r_plain.archive_configs)


def test_tapped_curve_with_constraints_and_a_ragged_chunk():
    """70 generations: two full 32-row chunks and a ragged one; infeasible
    points show in pop_feas and pop_viol_mean; the final hv equals the
    reference's numpy hypervolume of the port's own feasible archive."""
    ctx = ExecutionContext(device="cpu", telemetry="on")
    runner = CompiledNSGA2(_constrained_objs, n_bits=16, pop_size=16, n_gen=70, hv_ref=REF,
                           ctx=ctx)
    r = runner.run(seed=3, max_behav=3.0)
    taps = ctx.telemetry.series["fastmoo.gen"]
    assert [int(t["gen"]) for t in taps] == list(range(70))
    hvs = [float(t["hv"]) for t in taps]
    assert all(b >= a for a, b in zip(hvs, hvs[1:]))
    feas = r.archive_viol <= 0
    want = ref_hypervolume_2d(r.archive_objs[feas], REF)
    assert np.isclose(hvs[-1], want, rtol=1e-6)
    assert np.isclose(r.hv_history[-1][1], want, rtol=1e-6)
    assert any(float(t["pop_feas"]) < 1.0 for t in taps[:5])
    assert all((float(t["pop_viol_mean"]) > 0) == (float(t["pop_feas"]) < 1) for t in taps)
    assert int(taps[-1]["arc_feasible"]) == int(feas.sum())


def test_front_hypervolume_is_the_rounded_exact_area_and_rises_with_the_front():
    """The tap's per-generation hv: the front buffer's exact area (f64),
    rounded once to f32, so merging points never lowers it, even where an
    f32 sum of the staircase's rectangles would lose an ulp."""
    from repro_torch.core.fastmoo import front_hypervolume, front_update

    rng = np.random.default_rng(7)
    ref = torch.tensor([4.0e3, 3.0e5])
    buf = (torch.full((256,), float("inf")), torch.full((256,), float("inf")))
    last = 0.0
    for _ in range(60):
        objs = torch.from_numpy(rng.uniform([0, 0], [4.0e3, 3.0e5], (16, 2)).astype(np.float32))
        buf = front_update(*buf, objs, torch.zeros(16), ref)
        hv = float(front_hypervolume(*buf, ref))
        x, y = buf[0].double().numpy(), buf[1].double().numpy()
        keep = np.isfinite(x)
        exact = ref_hypervolume_2d(np.stack([x[keep], y[keep]], 1), ref.double().numpy())
        assert hv == float(np.float32(exact))
        assert hv >= last
        last = hv


def test_untapped_context_and_sweeps_emit_no_series():
    tel = tm.Telemetry("quiet")                     # device_taps defaults to False
    ctx = ExecutionContext(device="cpu", telemetry=tel)
    runner = CompiledNSGA2(_toy_objs, n_bits=16, pop_size=16, n_gen=4, hv_ref=REF, ctx=ctx)
    assert not runner._tapped
    runner.run(seed=0)
    assert "fastmoo.gen" not in tel.series
    assert tel.counter("dispatch.fastmoo.run") == 1
    assert any(s.name == "fastmoo.run" for s in tel.spans)
    on = ExecutionContext(device="cpu", telemetry="on")
    swept = CompiledNSGA2(_toy_objs, n_bits=16, pop_size=16, n_gen=4, hv_ref=REF, ctx=on)
    swept.run_sweep([0, 1], [(1e30, 1e30)] * 2)
    assert "fastmoo.gen" not in on.telemetry.series
    assert on.telemetry.counter("dispatch.fastmoo.sweep") == 1


def test_profile_fn_and_check_estimate_on_a_plain_matmul():
    tel = tm.Telemetry("p")
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    rec = profile_fn(torch.matmul, a, b, name="mm", tel=tel, iters=2)
    assert rec.cost["flops"] == 2 * 32 * 48 * 16
    assert rec.cost["ms"] > 0 and rec.cost["peak_bytes"] == 0.0
    assert tel.gauges["profile.mm.flops"] == rec.cost["flops"]
    assert tel.counter("profile.calls") == 1 and len(tel.series["profile"]) == 1
    check_estimate(rec, {"flops": 2 * 32 * 48 * 16, "bytes_accessed": 1}, tel=tel)
    assert rec.divergence == {"flops": 1.0} and rec.flagged == ()
    check_estimate(rec, {"flops": 2 * 32 * 48 * 16 / (DIVERGENCE_RATIO + 1)}, tel=tel)
    assert rec.flagged == ("flops",) and tel.counter("profile.estimate_divergence") == 1


def test_profile_registry_covers_every_kernel():
    tel = tm.Telemetry("p")
    recs = {r.name: r for r in profile_registry(tel=tel, device="cpu", iters=1)}
    kernels = {"fastchar.table", "fastchar.entry", "fastmoo.kernel", "fastapp.table",
               "fastapp.entry", "axo_matmul.kernel", "attention.kernel", "ssd_scan.kernel"}
    assert set(recs) == kernels | {"fastapp.gemm"}
    for name in kernels:
        r = recs[name]
        assert r.cost["ms"] > 0 and r.extra["bound_ms"] > 0 and r.extra["bound_share"] > 0
        assert set(r.estimate) == {"flops", "bytes_accessed", "transcendentals"}
    # the plain versions' counted FLOPs against cost_fn: K6 exactly, K7 counts
    # the masked half too (2x, the rule's edge), the gemm route is flagged
    assert recs["axo_matmul.kernel"].divergence == {"flops": 1.0}
    assert recs["attention.kernel"].divergence == {"flops": 2.0}
    assert "flops" in recs["fastapp.gemm"].divergence


def test_profile_registry_bound_counts_the_operands_own_bytes():
    """The roofline bound's bytes are what the call moves: K6's uint8 codes,
    its (2^n, R) f32 tables and its f32 output; K7's q and output at H heads
    and K/V at G, each at its own dtype -- not the cost formula's f32 count."""
    shapes = {"axo_matmul": dict(m=8, k=64, n=32, rank=2),
              "attention": dict(b=1, h=4, g=2, s=16, hd=16)}
    recs = {r.name: r for r in profile_registry(tel=tm.Telemetry("p"), device="cpu",
                                                iters=1, shapes=shapes)}
    k6, k7 = recs["axo_matmul.kernel"], recs["attention.kernel"]
    assert k6.extra["shape"] == shapes["axo_matmul"]
    assert k6.extra["bytes_moved"] == 8 * 64 + 64 * 32 + 4 * (2 * 256 * 2 + 256) + 4 * 8 * 32
    assert k7.extra["bytes_moved"] == 4 * (2 * 4 * 16 * 16 + 2 * 2 * 16 * 16)
    assert k6.estimate["bytes_accessed"] > k6.extra["bytes_moved"]
    for r in (k6, k7):
        assert r.extra["bound_ms"] == pytest.approx(1e3 * max(
            r.extra["bytes_moved"] / 3.35e12,
            r.estimate["flops"] / {"tf32": 494.7e12, "bf16": 989.4e12}[r.extra["peak_type"]]))


def test_profile_fn_times_a_closure_on_the_device_it_names(monkeypatch):
    """A closure passes no tensor for ``profile_fn`` to read its device from:
    ``profile_registry`` names it, so a card's kernels are timed by CUDA
    events, not by the host clock of their launch."""
    from repro_torch.obs import profile

    seen = []
    monkeypatch.setattr(profile, "time_ms",
                        lambda fn, device, iters: (seen.append(device.type), 1.0)[1])
    profile.profile_fn(lambda: None, name="c", tel=tm.Telemetry("p"), device="meta")
    assert seen == ["meta"]
    seen.clear()
    profile_registry(tel=tm.Telemetry("p"), device="cpu", iters=1)
    assert seen and set(seen) == {"cpu"}


@pytest.mark.gpu
def test_profile_registry_on_the_card_stays_within_the_roofline():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    shapes = {"axo_matmul": dict(m=512, k=2048, n=2048, rank=8),
              "attention": dict(b=4, h=32, g=8, s=128, hd=64)}
    for r in profile_registry(tel=tm.Telemetry("p"), device="cuda", iters=5, shapes=shapes):
        if "bound_share" in r.extra:
            assert 0.0 < r.extra["bound_share"] <= 1.0, (r.name, r.extra)


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    tel = tm.Telemetry("p", annotate=True)
    path = str(tmp_path / "t.json")
    with trace_capture(path, tel=tel):
        with tel.span("work"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    data = json.load(open(path))
    names = {e.get("name") for e in data["traceEvents"]}
    assert "work" in names and any("mm" in str(n) for n in names)
    assert tel.counter("profile.traces") == 1


def test_serve_main_writes_a_loadable_trace(tmp_path):
    from repro_torch.launch import serve

    path = str(tmp_path / "serve.json")
    res = serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--gen", "3",
                      "--prompt-len", "8", "--axo-rank", "0", "--trace", path])
    assert res["trace"] == path
    data = json.load(open(path))
    names = [e["name"] for e in data["traceEvents"] if e.get("ph") == "X"]
    assert {"serve.request", "serve.prefill", "serve.decode"} <= set(names)


def test_serve_run_keeps_its_kernels_once_a_shape_records():
    """A serving run's K6 plans record on the run's own telemetry, so its pad
    waste is its own path's, whatever ran before in the process.  K7 runs on
    the card only: on the CPU the model's attention is the blockwise plain
    function, which records no K7 plan."""
    from repro_torch.launch import serve

    args = ["--arch", "granite-3-2b", "--device", "cpu", "--gen", "2", "--prompt-len", "8",
            "--axo-rank", "2"]
    first, second = serve.main(args)["telemetry"], serve.main(args)["telemetry"]
    for tel in (first, second):
        k6 = tel.histogram_summary("axo_matmul.pad_waste")
        k7 = tel.histogram_summary("flash_attention.pad_waste")
        assert k6["count"] >= 2 and k7["count"] == 0
        assert tel.counter("jit.retrace.axo_matmul.plan") == k6["count"]
    assert second.histogram_summary("axo_matmul.pad_waste") == \
        first.histogram_summary("axo_matmul.pad_waste")


def test_profile_registry_raises_without_a_card():
    """``profile_registry`` measures the card by default: on a host without
    CUDA it raises, where it once ran the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_registry(tel=tm.Telemetry("p"), iters=1)


def test_healthz_carries_the_tuning_cache():
    from repro_torch.obs.prom import health_payload

    payload = health_payload(check_device=False)
    assert payload["tuning_cache"]["ok"] in (True, False)
    assert "path" in payload["tuning_cache"] or "error" in payload["tuning_cache"]
