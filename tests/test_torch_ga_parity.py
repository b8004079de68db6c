"""Three NSGA-II engines on one surrogate: the numpy GA, the reference's JAX
GA and the port's device GA (here on the CPU), over seeds 0-19.

On the card, ``chip_smoke.py`` phase ga found the port's mean feasible-archive
hypervolume 0.99% above the numpy GA's over seeds 0-19 (2.1 standard
errors).  This test runs the three engines on the same fitted 8-bit surrogate
(the reference's ``compile_surrogate_batch`` on ``tests/test_fastmoo.py``'s
150-config training set) at chip_smoke's settings (population 32, 30
generations) and holds each device engine's mean over the seeds within the
2% contract of the numpy mean.  The JAX GA shares the port's selection (a
stable ``lexsort`` on (rank, -crowding)); the numpy GA fills whole fronts and
breaks the last one by ``argsort(-crowding)``.  Run with ``-s`` to print the
means.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.core.automl import fit_estimators  # noqa: E402
from repro.core.dataset import BEHAV_KEY, PPA_KEY, build_training_dataset  # noqa: E402
from repro.core.fastchar import compile_surrogate_batch  # noqa: E402
from repro.core.fastmoo import CompiledNSGA2  # noqa: E402
from repro.core.moo import nsga2 as ref_nsga2  # noqa: E402
from repro.core.operator_model import spec_for  # noqa: E402

from repro_torch.core.engine import ExecutionContext  # noqa: E402
from repro_torch.core.moo import nsga2  # noqa: E402

SEEDS = range(20)
POP, GENS = 32, 30


@pytest.fixture(scope="module")
def hypervolumes():
    """Final feasible-archive hypervolume of each engine at each seed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spec = spec_for(8)
    ds = build_training_dataset(spec, n_random=150, seed=0, backend="jax")
    ests = fit_estimators(ds.configs.astype(np.float64),
                          {BEHAV_KEY: ds.metrics[BEHAV_KEY], PPA_KEY: ds.metrics[PPA_KEY]},
                          n_quad=16, seed=0)
    mb, mp = float(ds.metrics[BEHAV_KEY].max()), float(ds.metrics[PPA_KEY].max())
    ref = np.array([1.05 * mb, 1.05 * mp])
    fn = compile_surrogate_batch(ests, BEHAV_KEY, PPA_KEY, mb, mp)
    jax_ga = CompiledNSGA2(fn.objs_fn, n_bits=spec.n_luts, pop_size=POP, n_gen=GENS,
                           hv_ref=ref)

    def objs_torch(pop):
        return torch.from_numpy(np.array(fn.objs_fn(jnp.asarray(pop.numpy())), np.float32))

    hv = {"numpy": [], "jax": [], "port": []}
    for seed in SEEDS:
        runs = {
            "numpy": ref_nsga2(None, n_bits=spec.n_luts, pop_size=POP, n_gen=GENS, seed=seed,
                               eval_viol_fn=fn, hv_ref=ref),
            "jax": jax_ga.run(seed=seed, max_behav=mb, max_ppa=mp),
            "port": nsga2(None, n_bits=spec.n_luts, pop_size=POP, n_gen=GENS, seed=seed,
                          backend=ExecutionContext(device="cpu"), objs_device_fn=objs_torch,
                          max_behav=mb, max_ppa=mp, hv_ref=ref),
        }
        for name, r in runs.items():
            hv[name].append(r.hv_history[-1][1])
    torch.set_num_threads(n)
    return {k: np.array(v) for k, v in hv.items()}


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_mean_hypervolume_within_two_percent_of_numpy(hypervolumes, engine):
    base, got = hypervolumes["numpy"], hypervolumes[engine]
    assert base.min() > 0 and got.min() > 0
    rel = got.mean() / base.mean() - 1
    se = np.hypot(base.std(ddof=1), got.std(ddof=1)) / np.sqrt(len(base))
    print(f"\n{engine} GA mean hv {float(got.mean())!r} vs numpy {float(base.mean())!r} over seeds "
          f"{SEEDS.start}-{SEEDS.stop - 1}: {rel:+.4%} ({rel * base.mean() / se:+.2f} standard "
          f"errors of the difference)")
    assert abs(rel) <= 0.02
