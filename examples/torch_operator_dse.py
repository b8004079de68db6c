"""Operator- and application-level DSE on the paper's signed 8x8 multiplier, on the PyTorch port.

  PYTHONPATH=src python examples/torch_operator_dse.py [--const-sf 0.5] [--gens 40]
  PYTHONPATH=src python examples/torch_operator_dse.py --app mnist --device cpu
  PYTHONPATH=src python examples/torch_operator_dse.py --devices 4   # four cards

Compares GA-only (AppAxO-style), MaP-only and MaP+GA (AxOMaP) and prints the
validated Pareto fronts and hypervolumes, plus the EvoApprox-style frozen
library under the same constraints.  ``--app {ecg,mnist,gauss,ffn}``
switches the BEHAV objective to an application metric (paper Figs. 16-19).

Counterpart of ``examples/operator_dse.py``.  The execution policy is one
``ExecutionContext``: ``--backend torch`` (the default) runs
characterization, application BEHAV and the GA's generation loop on the
port's engines on ``--device`` (the kernels on the card, their plain
versions on the CPU), ``--backend numpy`` the host oracles (where the
reference names ``jax``; the port's GA follows the backend, so the
reference's ``--ga-backend`` has no counterpart); ``--devices N`` shards the ``--shard`` axes over N
cards (N host shards with ``--device cpu``).
"""

import argparse

from repro_torch.apps import APPLICATIONS
from repro_torch.core.dataset import BEHAV_KEY, PPA_KEY, build_training_dataset
from repro_torch.core.dse import (
    DSESettings,
    fixed_library,
    hv_reference,
    map_solution_pool,
    run_dse,
)
from repro_torch.core.engine import KERNEL_IMPLS, SHARD_AXES, ExecutionContext
from repro_torch.core.moo import hypervolume_2d
from repro_torch.core.operator_model import spec_for


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--const-sf", type=float, default=0.5)
    ap.add_argument("--gens", type=int, default=40)
    ap.add_argument("--pop", type=int, default=48)
    ap.add_argument("--n-random", type=int, default=1200)
    ap.add_argument("--app", choices=sorted(APPLICATIONS), default=None,
                    help="application-level DSE target (default: operator-level)")
    ap.add_argument("--backend", choices=("torch", "numpy"), default="torch",
                    help="characterization/app-BEHAV engine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--devices", type=int, default=None,
                    help="shard over N cards (N host shards with --device cpu)")
    ap.add_argument("--shard", choices=SHARD_AXES + ("all",), default="all",
                    help="which batch axes are sharded: 'configs', 'lanes' or both")
    ap.add_argument("--kernel-impl", choices=KERNEL_IMPLS + ("list",), default=None,
                    help="kernel or plain where an engine offers both (default: "
                         "kernel); 'list' prints the registered impls and exits")
    ap.add_argument("--tuning", choices=("off", "cached", "search"), default="off",
                    help="kernel tile autotune policy")
    ap.add_argument("--telemetry", choices=("on", "off"), default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the DSE spans to PATH")
    args = ap.parse_args(argv)

    if args.kernel_impl == "list":
        from repro_torch.kernels import registry

        print(registry.describe())
        return None

    telemetry = args.telemetry
    if args.trace is not None and telemetry is None:
        telemetry = "on"
    ctx = ExecutionContext(
        backend=args.backend,
        device=args.device if args.backend == "torch" else None,
        n_devices=args.devices,
        shard_axes=SHARD_AXES if args.shard == "all" else (args.shard,),
        kernel_impl=args.kernel_impl,
        tuning=args.tuning,
        telemetry=telemetry,
    )
    if ctx.device_count > 1:
        print(f"execution: {ctx.backend} on {ctx.device_count} devices, "
              f"sharding {','.join(ctx.shard_axes)}")

    spec = spec_for(8)
    print(f"signed 8x8 multiplier: L={spec.n_luts} -> 2^36 designs")
    ds = build_training_dataset(spec, n_random=args.n_random, seed=0, backend=ctx)
    print(f"training dataset: {len(ds)} characterized configs")

    app = None
    behav_key = BEHAV_KEY
    if args.app is not None:
        app = APPLICATIONS[args.app]()
        behav_key = app.behav_metric_name()
        ds = app.characterized_dataset(spec, ds, backend=ctx)
        print(f"application target: {args.app} (BEHAV = {behav_key}, "
              f"backend = {args.backend})")

    st = DSESettings(const_sf=args.const_sf, pop_size=args.pop, n_gen=args.gens,
                     n_quad_grid=(0, 4, 16), pool_size=6, seed=0,
                     behav_key=behav_key, context=ctx)
    ref = hv_reference(ds, st)
    pool = map_solution_pool(spec, ds, st)
    print(f"MaP pool: {len(pool)} configs (const_sf={args.const_sf})")

    results = {}
    for method in ("ga", "map", "map+ga"):
        r = run_dse(spec, ds, method, settings=st, map_pool=pool, ref=ref, app=app)
        results[method] = r
        stages = " ".join(f"{k}={v:.2f}s" for k, v in r.timings.items())
        print(f"{method:7s} hv_ppf={r.hv_ppf:.5g} hv_vpf={r.hv_vpf:.5g} "
              f"front={len(r.vpf_objs)} evals={r.n_evals} ({r.wall_s:.1f}s: {stages})")

    lib = fixed_library(spec)
    if app is not None:
        objs = app.characterize_fn(spec, backend=ctx)(lib)
    else:
        from repro_torch.core.dataset import characterize

        objs = characterize(spec, lib, backend=ctx).objectives()
    max_b = args.const_sf * ds.metrics[behav_key].max()
    max_p = args.const_sf * ds.metrics[PPA_KEY].max()
    feas = (objs[:, 0] <= max_b) & (objs[:, 1] <= max_p)
    hv_lib = hypervolume_2d(objs[feas], ref) if feas.any() else 0.0
    print(f"library hv_vpf={hv_lib:.5g} (feasible {int(feas.sum())}/{len(lib)})"
          " <- EvoApprox-style frozen baseline")

    ga, best = results["ga"], max(results["map"].hv_vpf, results["map+ga"].hv_vpf)
    print(f"\nAxOMaP vs GA-only: {100*(best - ga.hv_vpf)/max(ga.hv_vpf,1e-9):+.1f}% "
          f"validated hypervolume (paper reports up to +21% / +116% tight)")

    tel = ctx.tel
    if args.trace is not None:
        tel.to_chrome_trace(args.trace)
        print(f"chrome trace: {args.trace} ({len(tel.spans)} spans; load at ui.perfetto.dev)")
    if telemetry == "on":
        disp = {k: v for k, v in sorted(tel.counters.items())
                if k.startswith(("dispatch.", "registry.dispatch."))}
        print(f"telemetry: {len(tel.spans)} spans, dispatch counters {disp}")
        hv_taps = tel.series.get("fastmoo.gen", ())
        if hv_taps:
            print(f"per-generation hv taps: {len(hv_taps)} "
                  f"(final hv={float(hv_taps[-1]['hv']):.5g})")
    return {m: r.hv_vpf for m, r in results.items()} | {"library": hv_lib}


if __name__ == "__main__":
    main()
