"""Quickstart on the PyTorch port: the whole AxOMaP loop on the signed 4x4 multiplier.

  PYTHONPATH=src python examples/torch_quickstart.py              # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

1. characterize the design space (simulated synthesis + exhaustive behavior)
2. correlation analysis -> correlation-ranked quadratic terms
3. MIQCP battery -> MaP solution pool
4. MaP-augmented NSGA-II -> validated Pareto front
5. deploy the best config as serving arithmetic (rank-R ``axo_linear``, K6)

Counterpart of ``examples/quickstart.py``; every engine runs on ``--device``
through one ``ExecutionContext`` (the kernels on the card, their plain
versions on the CPU).
"""

import argparse

import numpy as np
import torch

from repro_torch.axo import AxOOperator, axo_linear
from repro_torch.core.correlation import bivariate_correlation
from repro_torch.core.dataset import build_training_dataset
from repro_torch.core.dse import DSESettings, map_solution_pool, run_dse
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import spec_for


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n-random", type=int, default=300)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--gens", type=int, default=20)
    args = ap.parse_args(argv)
    ctx = ExecutionContext(device=args.device)

    spec = spec_for(4)
    print(f"operator: signed {spec.n_bits}x{spec.n_bits} multiplier, "
          f"L={spec.n_luts} removable LUTs, {2**spec.n_luts} designs")

    # 1. characterization dataset (RANDOM + PATTERN)
    ds = build_training_dataset(spec, n_random=args.n_random, seed=0, backend=ctx)
    print(f"characterized {len(ds)} configs; "
          f"PDPLUT range [{ds.metrics['PDPLUT'].min():.0f}, "
          f"{ds.metrics['PDPLUT'].max():.0f}]")

    # 2. correlation analysis
    r = bivariate_correlation(ds.configs.astype(float), ds.metrics["PDPLUT"])
    print("top-3 PDPLUT-correlated LUTs:",
          ", ".join(f"LUT_{i} (r={r[i]:+.2f})" for i in np.argsort(-np.abs(r))[:3]))

    # 3 + 4. MaP pool -> MaP-augmented GA -> validated Pareto front
    st = DSESettings(const_sf=1.2, pop_size=args.pop, n_gen=args.gens, n_quad_grid=(0, 4),
                     pool_size=6, seed=0, context=ctx)
    pool = map_solution_pool(spec, ds, st)
    print(f"MaP solution pool: {len(pool)} configs")
    ga = run_dse(spec, ds, "ga", settings=st)
    mapga = run_dse(spec, ds, "map+ga", settings=st, map_pool=pool)
    print(f"hypervolume  GA-only={ga.hv_vpf:.4g}  MaP+GA={mapga.hv_vpf:.4g} "
          f"({100 * (mapga.hv_vpf - ga.hv_vpf) / max(ga.hv_vpf, 1e-9):+.1f}%)")
    print("validated Pareto front (BEHAV %, PDPLUT):")
    for (b, p), c in zip(mapga.vpf_objs[:6], mapga.vpf_configs[:6]):
        print(f"  {b:8.3f}  {p:10.1f}   config={''.join(map(str, c))}")

    # 5. deploy the most accurate front design (K6 on the card)
    best = mapga.vpf_configs[int(np.argmin(mapga.vpf_objs[:, 0]))]
    op = AxOOperator.from_config(best, rank=8, n_bits=4)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((8, 16)), dtype=torch.float32, device=ctx.device)
    w = torch.as_tensor(rng.standard_normal((16, 8)), dtype=torch.float32, device=ctx.device)
    y = axo_linear(x, w, op, ctx=ctx)
    rel = float(torch.linalg.norm(y - x @ w) / torch.linalg.norm(x @ w))
    print(f"deployed via rank-{op.rank} axo_linear: "
          f"relative deviation from exact fp32 matmul = {rel:.3%} "
          f"(int4 quantization + approximation)")
    return {"hv_ga": ga.hv_vpf, "hv_mapga": mapga.hv_vpf, "rel": rel}


if __name__ == "__main__":
    main()
