#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each printed on its own line, any failure raising (exit code != 0):

  1. device: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``.
  2. build: ``nvcc`` builds every kernel source of the port (in parallel);
     the ``-Xptxas -v`` summary (registers, shared memory, spills) is printed.
  3. kernels: K1 and K2 (BEHAV statistics), K3 (dominance counts) and K4 and
     K5 (table GEMV) are held against their plain PyTorch versions on the
     card at the shapes of the paths below -- int channels, counts and GEMV
     outputs exactly, the f32 channel to 1e-5 relative; K5 against K4 -- and
     timed with CUDA events beside the plain versions and a bound computed
     from the shapes.  K4/K5 run at the mnist head (D=128, M=250, K=256,
     N=10), the ffn GEMM1 (M=96, K=64, N=128) and a ragged K=100; their
     yardstick (``library_ms``) is the ``gemm`` route at the mnist shape, four
     cuBLAS f32 GEMMs.
  4. main path: the 8x8 signed-multiplier DSE of the paper at full scale
     (2,000 random + pattern training configs characterized exhaustively,
     105-problem MaP battery, NSGA-II at population 64 for 100 generations)
     through ``build_training_dataset``, ``map_solution_pool`` and ``run_dse``
     for ``ga``, ``map`` and ``map+ga``; the last one validates through the
     table-free kernel K2.  Kernel launch counts are zeroed before and read
     after; every kernel must have launched.  The validated fronts' BEHAV is
     checked against the numpy backend.
  apps: the application-targeted DSE (paper Table 2).  All four apps' BEHAV is
     attached to phase 4's training set with ``characterized_dataset_multi``
     (K4 for the mnist head and the ffn GEMM1), then ``run_dse(...,
     app=DigitClassification())`` runs ``ga`` and ``map`` (K4, K1, K3) and
     ``map+ga`` on ``kernel_impl="entry"`` (K5, K2, K3) at population 64 x 100
     generations.  Launch counts are zeroed before and read after; every
     kernel must have launched.  Then the checks: a 64-config subset of the
     training set's app BEHAV is held against the numpy oracle (ecg and mnist
     exactly, gauss and ffn to 1e-6 relative), and each validated front's
     APP_MNIST must equal the numpy oracle exactly, and its PPA too.
  5. GA contract: the device NSGA-II's feasible-archive hypervolume within 2%
     of the numpy NSGA-II on the fitted 8-bit surrogate (population 32, 30
     generations), as a mean over seeds 0-19.

The second-to-last lines are the kernels' JSON record (launch counts of K1-K3
from phase 4, of K4 and K5 from phase apps) and the card's
``nvidia-smi`` name and power limit; the last line is the result JSON.
Nothing of JAX or of the reference package is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published rates (NVIDIA data sheet): HBM3 bandwidth and non-tensor
# f32 FMA throughput.  The int32 rate is derived from the SM clock (below).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
N_SMS = 132
INT32_LANES_PER_SM = 64
REL_RTOL = 1e-5
# The two GAs draw from different random streams, and one run's hypervolume
# varies by ~1.6% (std over seeds) at this budget, so the 2% contract is held
# on the mean over a fixed set of seeds, and on seed 0 alone as well.
GA_SEEDS = tuple(range(20))


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, int_ops: float, f32_ops: float, int_rate: float):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(int_ops / int_rate, f32_ops / F32_FLOPS)
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card, no result",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.apps import APPLICATIONS, characterized_dataset_multi, fastapp
    from repro_torch.core import fastchar
    from repro_torch.core.automl import fit_estimators
    from repro_torch.core.dataset import BEHAV_KEY, PPA_KEY, Dataset, build_training_dataset
    from repro_torch.core.dse import DSESettings, hv_reference, map_solution_pool, run_dse
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.core.metrics import behav_metrics
    from repro_torch.core.moo import nsga2
    from repro_torch.core.operator_model import accurate_config, config_to_masks, spec_for
    from repro_torch.core.ppa import ppa_metrics
    from repro_torch.kernels import app_kernels, build, char_kernels, moo_kernels

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. device ----------------------------------------------------------
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_rate = N_SMS * INT32_LANES_PER_SM * clock_mhz * 1e6
    print(f"phase device: nvidia-smi '{card}', torch '{torch.cuda.get_device_name(0)}', "
          f"count {torch.cuda.device_count()}, max SM clock {clock_mhz:.0f} MHz, "
          f"derived int32 rate {int_rate:.4g} op/s, torch {torch.__version__} "
          f"cuda {torch.version.cuda}, python {sys.version.split()[0]}", flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"phase build: {sorted(built)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in built:
        for line in build.ptxas_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                print(f"  ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions ---------------------------------------
    spec = spec_for(8)
    rows, b_n = spec.rows, spec.n_inputs
    a_tile = fastchar.default_a_tile(spec)
    n_ta = b_n // a_tile
    rng = np.random.default_rng(0)
    cfgs = np.concatenate([
        rng.integers(0, 2, (256, spec.n_luts)).astype(np.uint8),
        accurate_config(spec)[None], np.zeros((1, spec.n_luts), np.uint8),
    ])
    d = len(cfgs)
    masks = torch.from_numpy(config_to_masks(spec, cfgs).astype(np.int32)).to(dev)
    small = fastchar._gather_small(masks, 8)
    _, exact, w = fastchar._device_tables(8, str(dev))

    i1, r1 = char_kernels.behav_stats_table(small, exact, w, a_tile)
    i1p, r1p = char_kernels.behav_stats_table_plain(small, exact, w, a_tile)
    i2, r2 = char_kernels.behav_stats_entry(masks, 8, a_tile)
    i2p, r2p = char_kernels.behav_stats_entry_plain(masks, 8, a_tile)
    torch.cuda.synchronize()
    for name, ik, ip, rk, rp in (("K1", i1, i1p, r1, r1p), ("K2", i2, i2p, r2, r2p)):
        if not torch.equal(ik, ip):
            raise AssertionError(f"{name} int channels differ from the plain version")
        torch.testing.assert_close(rk, rp, rtol=REL_RTOL, atol=0)
    if not torch.equal(i1, i2):
        raise AssertionError("K2 int channels differ from K1's")
    err = {"K1": float((r1 - r1p).abs().max()), "K2": float((r2 - r2p).abs().max())}

    pairs = d * b_n * b_n
    k1_int = pairs * (2 * rows + 2 + 12)   # per row shift+add; sub, abs; 6 channel updates
    k2_int = k1_int + pairs * 3 + d * rows * 4 * b_n * spec.width * 10  # + exact, chain
    out_bytes = 2 * n_ta * d * 8 * 4
    rec = {}
    rec["K1"] = dict(
        name="behav_stats_table", source="src/repro_torch/kernels/csrc/char_kernels.cu",
        replaces="src/repro/kernels/char_kernels.py:107",
        ms=cuda_ms(torch, lambda: char_kernels.behav_stats_table(small, exact, w, a_tile), 50),
        plain_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_table_plain(
            small, exact, w, a_tile), 5),
        bound=bound(small.numel() * 4 + 2 * b_n * b_n * 4 + out_bytes, k1_int, 2 * pairs,
                    int_rate),
    )
    rec["K2"] = dict(
        name="behav_stats_entry", source="src/repro_torch/kernels/csrc/char_kernels.cu",
        replaces="src/repro/kernels/char_kernels.py:226",
        ms=cuda_ms(torch, lambda: char_kernels.behav_stats_entry(masks, 8, a_tile), 50),
        plain_ms=cuda_ms(torch, lambda: char_kernels.behav_stats_entry_plain(
            masks, 8, a_tile), 5),
        bound=bound(masks.numel() * 4 + out_bytes, k2_int, 3 * pairs, int_rate),
    )
    print(f"phase kernels: K1/K2 vs plain at D={d} configs, A=B={b_n}, a_tile={a_tile}: "
          f"int channels ==, f32 channel rtol {REL_RTOL} (max abs err K1 {err['K1']:.3g}, "
          f"K2 {err['K2']:.3g}); K2 int == K1 int", flush=True)

    for p in (64, 128, 1000):
        g = np.random.default_rng(p)
        objs = g.random((p, 2)).astype(np.float32)
        viol = np.where(g.random(p) < 0.4, g.random(p), 0.0).astype(np.float32)
        active = g.random(p) < 0.7
        pad = (-p) % 128 if p == 1000 else 0   # inactive +inf-violation pad rows
        o = torch.from_numpy(np.concatenate([objs, np.zeros((pad, 2), np.float32)])).to(dev)
        v = torch.from_numpy(np.concatenate([viol, np.full(pad, np.inf, np.float32)])).to(dev)
        a = torch.from_numpy(np.concatenate([active, np.zeros(pad, bool)])).to(dev)
        got = moo_kernels.dominance_counts(o, v, a)
        want = moo_kernels.dominance_counts_plain(o, v, a)
        unpadded = moo_kernels.dominance_counts_plain(o[:p], v[:p], a[:p])
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got[:p], unpadded)):
            raise AssertionError(f"K3 counts differ from the plain version at P={p}")
        print(f"phase kernels: K3 vs plain at P={p} (+{pad} pad rows): counts ==", flush=True)
        if p == 128:  # the environmental-selection shape of the main path (2 x pop)
            o3, v3, a3 = o, v, a
    rec["K3"] = dict(
        name="dominance_counts", source="src/repro_torch/kernels/csrc/moo_kernels.cu",
        replaces="src/repro/kernels/moo_kernels.py:95",
        ms=cuda_ms(torch, lambda: moo_kernels.dominance_counts(o3, v3, a3), 200),
        plain_ms=cuda_ms(torch, lambda: moo_kernels.dominance_counts_plain(o3, v3, a3), 50),
        bound=bound(128 * (4 * 2 + 4 + 1 + 4), 128 * 128 * 8, 0, int_rate),
    )
    err["K3"] = 0.0  # integer counts, held equal above

    # K4/K5 on 126 random configs + the accurate and the all-zeros config, at
    # the mnist head and the ffn GEMM1 (the apps' own codes) and a ragged K
    app_cfgs = np.concatenate([cfgs[:126], cfgs[-2:]])
    d_app = len(app_cfgs)
    tb = fastapp.table_batch(spec, app_cfgs, ctx=ExecutionContext())
    tflat = tb.tables.reshape(d_app, -1)
    mnist_app, ffn_app = APPLICATIONS["mnist"](), APPLICATIONS["ffn"]()
    g = np.random.default_rng(1)
    gemv_shapes = {
        "mnist": (mnist_app._x_codes, mnist_app._w_codes),
        "ffn": (ffn_app._x_codes, ffn_app._w1_codes),
        "ragged": (g.integers(0, b_n, (250, 100)), g.integers(0, b_n, (100, 10))),
    }
    for label, (a_np, b_np) in gemv_shapes.items():
        a = torch.from_numpy(np.asarray(a_np, np.int32)).to(dev)
        bb = torch.from_numpy(np.asarray(b_np, np.int32)).to(dev)
        (m, k), n = a.shape, bb.shape[1]
        k4 = app_kernels.table_gemv(tflat, a, bb)
        k5 = app_kernels.entry_gemv(tb.masks, a, bb, 8)
        p4 = app_kernels.table_gemv_plain(tflat, a, bb)
        p5 = app_kernels.entry_gemv_plain(tb.masks, a, bb, 8)
        gemm = fastapp._matmul_gemm(tb.small, a, bb)
        torch.cuda.synchronize()
        if not (torch.equal(k4, p4) and torch.equal(k5, p5)):
            raise AssertionError(f"K4/K5 differ from their plain versions at {label}")
        if not (torch.equal(k5, k4) and torch.equal(gemm, k4)):
            raise AssertionError(f"K5 or the gemm route differs from K4 at {label}")
        # ALU operations only: per lookup K4 adds the index and accumulates (its
        # table load issues on the load/store pipe); K5 per row adds the index,
        # shifts and accumulates, and synthesizes each config's planes once
        lookups = d_app * m * n * k
        io_bytes = (a.numel() + bb.numel() + d_app * m * n) * 4
        synth_ops = d_app * rows * 4 * b_n * spec.width * 10   # once per config
        k4_rec = dict(
            name="table_gemv", source="src/repro_torch/kernels/csrc/app_kernels.cu",
            replaces="src/repro/kernels/app_kernels.py:74",
            ms=cuda_ms(torch, lambda: app_kernels.table_gemv(tflat, a, bb), 20),
            plain_ms=cuda_ms(torch, lambda: app_kernels.table_gemv_plain(tflat, a, bb), 3),
            library_ms=cuda_ms(torch, lambda: fastapp._matmul_gemm(tb.small, a, bb), 20),
            bound=bound(tflat.numel() * 4 + io_bytes, 2 * lookups, 0, int_rate),
        )
        k5_rec = dict(
            name="entry_gemv", source="src/repro_torch/kernels/csrc/app_kernels.cu",
            replaces="src/repro/kernels/app_kernels.py:173",
            ms=cuda_ms(torch, lambda: app_kernels.entry_gemv(tb.masks, a, bb, 8), 20),
            plain_ms=cuda_ms(torch, lambda: app_kernels.entry_gemv_plain(
                tb.masks, a, bb, 8), 3),
            library_ms=k4_rec["library_ms"],
            bound=bound(tb.masks.numel() * 4 + io_bytes, 3 * rows * lookups + synth_ops, 0,
                        int_rate),
        )
        print(f"phase kernels: K4/K5 vs plain at {label} D={d_app} M={m} K={k} N={n}: "
              f"outputs ==, K5 == K4 == gemm route; K4 {k4_rec['ms']:.4f} ms (plain "
              f"{k4_rec['plain_ms']:.4f}, bound {k4_rec['bound'][0]:.4g} by "
              f"{k4_rec['bound'][1]}), K5 {k5_rec['ms']:.4f} ms (plain "
              f"{k5_rec['plain_ms']:.4f}, bound {k5_rec['bound'][0]:.4g} by "
              f"{k5_rec['bound'][1]}), gemm route (4 cuBLAS f32 GEMMs) "
              f"{k4_rec['library_ms']:.4f} ms", flush=True)
        if label == "mnist":   # the shape of the app path's GEMV (mnist's logits)
            rec["K4"], rec["K5"] = k4_rec, k5_rec
    err["K4"] = err["K5"] = 0.0  # exact int32 outputs, held equal above
    for k, r in rec.items():
        print(f"phase kernels: {k} {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound'][0]:.4g} ms by {r['bound'][1]})", flush=True)

    # -- 4. main path -------------------------------------------------------
    ctx = ExecutionContext()                           # the card, K1 + K3
    ctx_entry = ExecutionContext(kernel_impl="entry")  # the card, K2 + K3
    wrappers = {"K1": char_kernels.behav_stats_table, "K2": char_kernels.behav_stats_entry,
                "K3": moo_kernels.dominance_counts}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    train = build_training_dataset(spec, n_random=2000, seed=0, backend=ctx)
    t_char = time.perf_counter() - t0
    print(f"phase main: training set {len(train)} configs characterized on the card in "
          f"{t_char:.2f} s (K1 launches {wrappers['K1'].launches})", flush=True)
    settings = DSESettings(const_sf=0.5, pop_size=64, n_gen=100, context=ctx)
    t0 = time.perf_counter()
    pool = map_solution_pool(spec, train, settings)
    ref = hv_reference(train, settings)
    print(f"phase main: MaP pool {len(pool)} configs in {time.perf_counter() - t0:.2f} s, "
          f"hv reference {ref.tolist()}", flush=True)
    results = {}
    for method in ("ga", "map", "map+ga"):
        st = settings if method != "map+ga" else DSESettings(
            const_sf=0.5, pop_size=64, n_gen=100, context=ctx_entry)
        r = run_dse(spec, train, method, settings=st, map_pool=pool, ref=ref)
        results[method] = r
        print(f"phase main: {method} hv_ppf {r.hv_ppf!r} hv_vpf {r.hv_vpf!r} n_evals "
              f"{r.n_evals} vpf {len(r.vpf_configs)} timings "
              f"{ {k: round(v, 3) for k, v in r.timings.items()} } launches since start "
              f"K1 {wrappers['K1'].launches} K2 {wrappers['K2'].launches} "
              f"K3 {wrappers['K3'].launches}", flush=True)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    t_main = time.perf_counter() - t0 + t_char
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    for method, r in results.items():
        if not (r.hv_vpf > 0 and np.isfinite(r.vpf_objs).all()):
            raise AssertionError(f"{method}: empty or non-finite validated front")
        fast = behav_metrics(spec, r.vpf_configs, backend=ctx)
        oracle = behav_metrics(spec, r.vpf_configs, backend="numpy")
        for key in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
            np.testing.assert_array_equal(fast[key], oracle[key], err_msg=f"{method} {key}")
        np.testing.assert_allclose(fast[BEHAV_KEY], oracle[BEHAV_KEY], rtol=REL_RTOL)
        np.testing.assert_allclose(r.vpf_objs[:, 0], oracle[BEHAV_KEY], rtol=REL_RTOL)
    print(f"phase main: {t_main:.1f} s, launches {launches}; validated fronts' BEHAV == "
          f"numpy backend (4 metrics), AVG_ABS_REL_ERR rtol {REL_RTOL}", flush=True)

    # -- apps: application-targeted DSE ------------------------------------
    apps = [APPLICATIONS[name]() for name in ("ecg", "mnist", "gauss", "ffn")]
    mnist = apps[1]
    app_wrappers = dict(wrappers, K4=app_kernels.table_gemv, K5=app_kernels.entry_gemv)
    for fn in app_wrappers.values():
        fn.launches = 0
    t_app0 = time.perf_counter()
    train_app = characterized_dataset_multi(apps, spec, train, backend=ctx)
    t_multi = time.perf_counter() - t_app0
    print(f"phase apps: 4 apps' BEHAV attached to {len(train)} configs on the card in "
          f"{t_multi:.2f} s (K4 launches {app_kernels.table_gemv.launches})", flush=True)
    st_app = DSESettings(behav_key="APP_MNIST", const_sf=0.5, pop_size=64, n_gen=100,
                         context=ctx)
    t0 = time.perf_counter()
    pool_app = map_solution_pool(spec, train_app, st_app)
    ref_app = hv_reference(train_app, st_app)
    print(f"phase apps: APP_MNIST MaP pool {len(pool_app)} configs in "
          f"{time.perf_counter() - t0:.2f} s, hv reference {ref_app.tolist()}", flush=True)
    app_results = {}
    for method in ("ga", "map", "map+ga"):
        st = st_app if method != "map+ga" else DSESettings(
            behav_key="APP_MNIST", const_sf=0.5, pop_size=64, n_gen=100, context=ctx_entry)
        r = run_dse(spec, train_app, method, settings=st, map_pool=pool_app, ref=ref_app,
                    app=mnist)
        app_results[method] = r
        print(f"phase apps: {method} hv_ppf {r.hv_ppf!r} hv_vpf {r.hv_vpf!r} n_evals "
              f"{r.n_evals} vpf {len(r.vpf_configs)} timings "
              f"{ {k: round(v, 3) for k, v in r.timings.items()} } launches since start "
              f"{ {k: fn.launches for k, fn in app_wrappers.items()} }", flush=True)
    torch.cuda.synchronize()
    app_launches = {k: fn.launches for k, fn in app_wrappers.items()}
    t_app = time.perf_counter() - t_app0
    if min(app_launches.values()) <= 0:
        raise AssertionError(f"a kernel of the app path never launched: {app_launches}")
    # checks of the app path, after its launch counts and time are read
    pick = np.random.default_rng(2).choice(len(train), 62, replace=False)
    chk = np.concatenate([train.configs[pick], cfgs[-1:], cfgs[-2:-1]])  # + zeros, accurate
    chk_ds = Dataset(configs=chk, metrics={}, source=np.zeros(len(chk), np.uint8))
    fast = characterized_dataset_multi(apps, spec, chk_ds, backend=ctx).metrics
    oracle = characterized_dataset_multi(apps, spec, chk_ds, backend="numpy").metrics
    for app in apps:
        key = app.behav_metric_name()
        np.testing.assert_array_equal(train_app.metrics[key][pick], fast[key][:62])
        if app.name in ("ecg", "mnist"):
            np.testing.assert_array_equal(fast[key], oracle[key], err_msg=key)
        else:
            np.testing.assert_allclose(fast[key], oracle[key], rtol=1e-6, err_msg=key)
    print("phase apps: 64-config subset of the training set's app BEHAV == numpy oracle "
          "(ecg, mnist exactly; gauss, ffn rtol 1e-6)", flush=True)
    for method, r in app_results.items():
        if not (len(r.vpf_configs) > 0 and np.isfinite(r.vpf_objs).all()):
            raise AssertionError(f"app {method}: empty or non-finite validated front")
        np.testing.assert_array_equal(
            r.vpf_objs[:, 0], mnist.behav(spec, r.vpf_configs, backend="numpy"),
            err_msg=f"app {method} APP_MNIST")
        np.testing.assert_array_equal(
            r.vpf_objs[:, 1], ppa_metrics(spec, r.vpf_configs)[PPA_KEY],
            err_msg=f"app {method} {PPA_KEY}")
    print(f"phase apps: {t_app:.1f} s, launches {app_launches}; validated fronts' "
          f"APP_MNIST == numpy oracle, {PPA_KEY} == numpy", flush=True)
    launches.update(K4=app_launches["K4"], K5=app_launches["K5"])

    # -- 5. GA hypervolume contract -----------------------------------------
    small_ds = build_training_dataset(spec, n_random=150, seed=0, backend=ctx)
    ests = fit_estimators(
        small_ds.configs.astype(np.float64),
        {BEHAV_KEY: small_ds.metrics[BEHAV_KEY], PPA_KEY: small_ds.metrics[PPA_KEY]},
        n_quad=16, seed=0,
    )
    mb = float(small_ds.metrics[BEHAV_KEY].max())
    mp = float(small_ds.metrics[PPA_KEY].max())
    hv_ref = np.array([1.05 * mb, 1.05 * mp])
    fn = fastchar.compile_surrogate_batch(ests, BEHAV_KEY, PPA_KEY, mb, mp, ctx=ctx)
    hv_np, hv_t = [], []
    for seed in GA_SEEDS:
        r_np = nsga2(None, n_bits=spec.n_luts, pop_size=32, n_gen=30, seed=seed,
                     eval_viol_fn=fn, hv_ref=hv_ref, backend="numpy")
        r_t = nsga2(None, n_bits=spec.n_luts, pop_size=32, n_gen=30, seed=seed,
                    backend=ctx, objs_device_fn=fn.objs_fn, max_behav=mb, max_ppa=mp,
                    hv_ref=hv_ref)
        hv_np.append(r_np.hv_history[-1][1])
        hv_t.append(r_t.hv_history[-1][1])
    rel = abs(np.mean(hv_t) - np.mean(hv_np)) / np.mean(hv_np)
    rel0 = abs(hv_t[0] - hv_np[0]) / hv_np[0]
    print(f"phase ga: seeds {list(GA_SEEDS)}: numpy nsga2 hv {hv_np}, device nsga2 hv "
          f"{hv_t}; mean {float(np.mean(hv_np))!r} vs {float(np.mean(hv_t))!r}, rel diff {rel:.3g} "
          f"(limit 0.02); seed-0 rel diff {rel0:.3g} (limit 0.02)", flush=True)
    if not (min(hv_np) > 0 and rel <= 0.02):
        raise AssertionError("device GA mean hypervolume is not within 2% of the numpy GA")
    if not rel0 <= 0.02:
        raise AssertionError("device GA seed-0 hypervolume is not within 2% of the numpy GA")

    kernels = []
    for k, r in rec.items():
        kernels.append({
            "name": r["name"], "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches[k], "max_abs_err": err[k],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
        })
    print(f"phase done: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
