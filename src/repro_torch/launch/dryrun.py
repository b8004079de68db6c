"""Multi-card dry-run: trace every (arch x shape x mesh) cell on a fake world.

Counterpart of ``repro/launch/dryrun.py``.  Proves the distribution config
is coherent without hardware: a world of 256 or 512 fake ranks
(``launch.lowering.fake_world``, ``torch.distributed``'s ``fake`` backend)
backs the production meshes (``launch.mesh.make_production_mesh``, re-made
for each mesh), and each cell's step is traced once on fake tensors from
its abstract parameters and inputs (``launch.lowering.lower_step``, no
allocation), through DTensor's sharding propagation and every collective
it issues.  The record holds rank 0's argument and peak live bytes, FLOPs,
bytes accessed, collective bytes by kind and a roofline row on the H100
(``launch.roofline.Roofline``: HBM, the bf16 tensor-core peak and NVLink),
with the reference's keys.  There is no compile step: ``t_trace_s`` (the
trace) stands beside ``t_lower_s`` (setting the cell up and tracing it) and
no ``t_compile_s`` is written.  The HBM check is against the card's 80 GB
(``fits_h100_hbm``).

``--probe`` traces the cost probes (``costprobe.py``, each stage's
super-block once and twice, ``double="repeats"``) in place of the full
step and extrapolates: a full-depth cell's trace is slow (DTensor dispatch
on the host, per op and per layer), the probes' are one and two
super-blocks deep, and the extrapolation equals the full trace for the
costs and the argument bytes.  The peak is extrapolated the same way, an
estimate, and the probe-corrected record has no ``raw_*`` numbers.

Usage:
  python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--out DIR]
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k \
      --mesh single --reduced --device cpu        # a mini cell on the CPU
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

from ..configs.base import SHAPES
from ..configs.registry import ARCH_IDS, arch_for_shape, cell_status, get_arch, rules_for
from .accounting import param_counts
from .costprobe import corrected_costs, measure, probe_variants
from .lowering import fake_world, lower_step
from .mesh import MULTIPOD_SHAPE, POD_SHAPE, make_production_mesh
from .roofline import H100_SXM, Roofline, model_flops

__all__ = ["run_cell", "main", "HBM_BYTES"]

HBM_BYTES = 80 * 10**9   # the H100 SXM5's 80 GB


def _world_for(multi_pod: bool, device: str):
    """The production mesh on a fake world of its size (re-made if the
    world has another size)."""
    import torch.distributed as dist

    n = math.prod(MULTIPOD_SHAPE if multi_pod else POD_SHAPE)
    if not dist.is_initialized() or dist.get_world_size() != n:
        fake_world(n)
    return make_production_mesh(multi_pod=multi_pod, device_type=device)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             probe: bool = False, device: str = "cuda", mesh=None, cfg=None) -> dict:
    """One cell's record (module docstring).  ``mesh`` (default: the
    production mesh on a fake world of its size) and ``cfg`` (default: the
    arch's config) let a caller trace a cut-down cell; ``device`` is the fake
    tensors' device (``"cpu"`` on a machine whose PyTorch lacks CUDA)."""
    mesh_name = "2x16x16" if multi_pod else "16x16"
    status = cell_status(arch_id, shape_name)
    if status != "run":
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "status": status}

    shape = SHAPES[shape_name]
    cfg = arch_for_shape(get_arch(arch_id) if cfg is None else cfg, shape)
    t0 = time.time()
    if mesh is None:
        mesh = _world_for(multi_pod, device)
    names = mesh.mesh_dim_names
    rules = rules_for(cfg, shape, mesh_model=mesh.size(names.index("model")),
                      mesh_data=mesh.size(names.index("data")))
    chips = mesh.size()

    raw = None
    t_trace = t_probe = 0.0
    if probe:
        t1 = time.time()
        measures = {tag: measure(lower_step(pcfg, shape, mesh, rules, device=device))
                    for tag, pcfg in probe_variants(cfg, double="repeats").items()}
        use = corrected_costs(cfg, measures)
        t_probe = time.time() - t1
    else:
        rec = lower_step(cfg, shape, mesh, rules, device=device)
        t_trace = rec["t_trace_s"]
        raw = use = measure(rec)
    t_lower = time.time() - t0

    counts = param_counts(cfg)
    n_active = counts["active_nonemb"] + counts["embedding"] // (
        2 if not cfg.tie_embeddings else 1)
    mfl = model_flops(cfg, shape, n_active, shape.kind)
    rl = Roofline(
        arch=arch_id, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=use["flops"], hlo_bytes=use["bytes"], coll_bytes=use["coll_total"],
        coll_breakdown={k[5:]: v for k, v in use.items()
                        if k.startswith("coll_") and k != "coll_total"},
        bytes_per_device=use["peak_bytes"], model_flops=mfl, hw=H100_SXM,
    )

    if verbose:
        print(f"--- {arch_id} x {shape_name} x {mesh_name} ---")
        print("memory: arguments %.3e B, peak %.3e B" %
              (use["argument_size_in_bytes"], use["peak_bytes"]))
        label = "corrected" if probe else "traced"
        print("cost (%s): flops=%.3e bytes=%.3e coll=%.3e" %
              (label, use["flops"], use["bytes"], use["coll_total"]))
        print("roofline: t_comp=%.4fs t_mem=%.4fs t_coll=%.4fs -> %s" %
              (rl.t_compute, rl.t_memory, rl.t_collective, rl.bottleneck))

    rec = {"status": "ok", "t_lower_s": t_lower, "t_trace_s": t_trace,
           "t_probe_s": t_probe, "probe_corrected": probe}
    rec.update(rl.row())
    rec["raw_flops"] = None if raw is None else raw["flops"]
    rec["raw_bytes"] = None if raw is None else raw["bytes"]
    rec["raw_coll_bytes"] = None if raw is None else raw["coll_total"]
    rec["coll_breakdown"] = rl.coll_breakdown
    rec["params_total"] = counts["total"]
    rec["params_active"] = counts["active"]
    rec["argument_size_in_bytes"] = int(use["argument_size_in_bytes"])
    rec["temp_size_in_bytes"] = int(use["peak_bytes"] - use["argument_size_in_bytes"])
    # the step updates its parameters and state in place, so the peak is the need
    rec["hbm_need_bytes"] = int(use["peak_bytes"])
    rec["fits_h100_hbm"] = bool(rec["hbm_need_bytes"] <= HBM_BYTES)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="trace the cost probes and extrapolate (full-depth cells)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose JSON already records status=ok/skip")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no card is used either way; a "
                         "train cell's backward on 'cuda' needs PyTorch built for CUDA)")
    ap.add_argument("--reduced", action="store_true",
                    help="trace each arch's reduced config (a mini cell, for the CPU)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    if args.list:
        for a, s, m in cells:
            print(a, s, "2x16x16" if m else "16x16", cell_status(a, s))
        return 0

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for a, s, m in cells:
        mesh_name = "2x16x16" if m else "16x16"
        out_path = os.path.join(args.out, f"{a}__{s}__{mesh_name}.json")
        if args.skip_existing and os.path.exists(out_path):
            with open(out_path) as f:
                prev = json.load(f)
            st = str(prev.get("status", ""))
            if st == "ok" and (prev.get("probe_corrected") or not args.probe):
                print(f"[cached] {a} {s} {mesh_name}")
                continue
            if st.startswith("skip"):
                print(f"[cached-skip] {a} {s} {mesh_name}")
                continue
        try:
            rec = run_cell(a, s, m, verbose=not args.quiet, probe=args.probe,
                           device=args.device,
                           cfg=get_arch(a).reduced() if args.reduced else None)
        except Exception as exc:  # noqa: BLE001 -- the record says what failed
            traceback.print_exc()
            rec = {"arch": a, "shape": s, "mesh": mesh_name,
                   "status": f"FAIL: {type(exc).__name__}: {exc}"}
            failures += 1
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        print(f"[{rec.get('status', '?')}] {a} {s} {mesh_name}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
