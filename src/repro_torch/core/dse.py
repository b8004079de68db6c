"""End-to-end DSE pipelines (AxOMaP §4.3, Figs. 11-19).

Three search methods over the binary LUT-config space, all sharing one
surrogate-estimator stack and one hypervolume accounting:

  * ``map``     -- solve the MaP problem battery (wt_B sweep x quad-term sweep x
                   const_sf bounds) and take the union solution pool.
  * ``ga``      -- problem-agnostic NSGA-II on surrogate fitness, random init
                   (this is the AppAxO-style baseline).
  * ``map+ga``  -- NSGA-II seeded with the MaP pool (the paper's contribution).

PPF (pseudo Pareto front) = Pareto filter under *estimated* metrics of everything
the search evaluated; VPF (validated Pareto front) = the PPF re-characterized with
the actual synthesis+behavioral models and Pareto-filtered again.  Hypervolumes for
both are reported against a shared reference point derived from the training set.

``fixed_library`` is the EvoApprox-style baseline: a frozen, search-free library of
classic truncation/removal designs, only feasibility-filtered per problem.

``run_dse_sweep`` runs a (seeds x const_sf) grid as one batched GA
(``fastmoo.CompiledNSGA2.run_sweep``), and ``store=`` (a
``repro_torch.service.OperatorStore``) puts the persistent operator library
behind either entry point.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .automl import AutoMLRegressor, fit_estimators
from .correlation import rank_quadratic_terms
from .dataset import BEHAV_KEY, PPA_KEY, Dataset, characterize, gen_random
from .engine import ExecutionContext, as_context
from .miqcp import MapProblem, build_problems, solve_pool
from .moo import GAResult, hypervolume_2d, nsga2, pareto_mask
from .operator_model import OperatorSpec
from .regression import fit_poly

__all__ = [
    "DSESettings",
    "DSEResult",
    "hv_reference",
    "map_solution_pool",
    "run_dse",
    "run_dse_sweep",
    "fixed_library",
    "CONST_SF_GRID",
]

# The paper's constraint-scaling grid (Eq. 8).
CONST_SF_GRID = (0.2, 0.5, 0.8, 1.0, 1.2, 1.5)


@dataclass
class DSESettings:
    """Knobs shared by every method (defaults sized for the 8x8 operator).

    ``context`` is the execution policy
    (:class:`repro_torch.core.engine.ExecutionContext`): backend, device and
    kernel-impl preference, consumed by every engine ``run_dse`` touches.
    ``None`` means the torch engines on the card.
    """

    ppa_key: str = PPA_KEY
    behav_key: str = BEHAV_KEY
    const_sf: float = 1.0
    pop_size: int = 64
    n_gen: int = 100                     # paper uses up to 250; 100 is the default budget here
    n_quad_grid: tuple[int, ...] = (0, 4, 8, 16, 32)
    wt_step: float = 0.05
    pool_size: int = 8
    seed: int = 0
    n_estimator_quad: int = 48
    context: ExecutionContext | None = None

    def __post_init__(self) -> None:
        if self.context is None:
            self.context = ExecutionContext()
        elif not isinstance(self.context, ExecutionContext):
            raise TypeError(
                f"context must be an ExecutionContext, got {type(self.context).__name__}"
            )


@dataclass
class DSEResult:
    method: str
    settings: DSESettings
    ppf_configs: np.ndarray              # (P, L)
    ppf_objs_est: np.ndarray             # (P, 2) [BEHAV, PPA] estimated
    vpf_configs: np.ndarray              # (V, L)
    vpf_objs: np.ndarray                 # (V, 2) characterized
    hv_ppf: float
    hv_vpf: float
    n_evals: int
    wall_s: float                        # total (back-compat; = sum over stages + overhead)
    hv_history: list[tuple[int, float]] = field(default_factory=list)
    ref_point: np.ndarray | None = None
    # per-stage wall clock (perf_counter seconds): "characterize" (estimator
    # fit + surrogate build), "map" (MaP battery; absent for method="ga" or a
    # caller-supplied pool), "ga" (search/eval + PPF), "validate" (ground-truth
    # re-characterization).
    timings: dict[str, float] = field(default_factory=dict)


def hv_reference(train_ds: Dataset, settings: DSESettings, margin: float = 1.05) -> np.ndarray:
    """Shared hypervolume reference point: training-set maxima with a margin."""
    b = train_ds.metrics[settings.behav_key].max()
    p = train_ds.metrics[settings.ppa_key].max()
    return np.array([margin * b, margin * p], dtype=np.float64)


def _constraint_bounds(train_ds: Dataset, settings: DSESettings) -> tuple[float, float]:
    """(max_behav, max_ppa) in original units: const_sf x training maxima (Eq. 8)."""
    b_max = float(train_ds.metrics[settings.behav_key].max())
    p_max = float(train_ds.metrics[settings.ppa_key].max())
    return settings.const_sf * b_max, settings.const_sf * p_max


def map_solution_pool(
    spec: OperatorSpec,
    train_ds: Dataset,
    settings: DSESettings,
    backend=None,
) -> np.ndarray:
    """Union MaP solution pool over the wt_B x n_quad battery (§4.3.1).

    ``backend`` (default ``settings.context``; a string is also accepted) is
    forwarded to the MaP solvers; under the torch backend the
    exhaustive-enumeration scoring of each problem runs as one batched device
    evaluation (``fastchar.map_problem_values``), and tabu-sized batteries
    (L > 16) advance all problems' starts in lockstep
    (``miqcp.solve_tabu_multi``).
    """
    backend = settings.context if backend is None else as_context(backend)
    X = train_ds.configs.astype(np.float64)
    yb = train_ds.metrics[settings.behav_key]
    yp = train_ds.metrics[settings.ppa_key]
    b_max, p_max = float(yb.max()), float(yp.max())

    ranked_b = rank_quadratic_terms(X, yb)
    ranked_p = rank_quadratic_terms(X, yp)

    wt_grid = np.arange(0.0, 1.0 + 1e-9, settings.wt_step)
    problems: list[MapProblem] = []
    for n_quad in settings.n_quad_grid:
        bm = fit_poly(X, yb, quad_pairs=ranked_b[:n_quad])
        pm = fit_poly(X, yp, quad_pairs=ranked_p[:n_quad])
        problems.extend(
            build_problems(
                bm, pm, b_max, p_max, settings.const_sf,
                wt_grid=wt_grid, n_quad=n_quad,
            )
        )
    return solve_pool(
        problems, seed=settings.seed, pool_size=settings.pool_size, backend=backend
    )


def _surrogate_eval(
    estimators: dict[str, AutoMLRegressor], settings: DSESettings
) -> Callable[[np.ndarray], np.ndarray]:
    eb = estimators[settings.behav_key]
    ep = estimators[settings.ppa_key]

    def eval_fn(configs: np.ndarray) -> np.ndarray:
        X = configs.astype(np.float64)
        return np.stack([eb.predict(X), ep.predict(X)], axis=-1)

    return eval_fn


def _violation_fn(
    estimators: dict[str, AutoMLRegressor],
    settings: DSESettings,
    max_behav: float,
    max_ppa: float,
) -> Callable[[np.ndarray], np.ndarray]:
    eb = estimators[settings.behav_key]
    ep = estimators[settings.ppa_key]

    def viol(configs: np.ndarray) -> np.ndarray:
        X = configs.astype(np.float64)
        vb = np.maximum(0.0, eb.predict(X) - max_behav) / max(abs(max_behav), 1e-9)
        vp = np.maximum(0.0, ep.predict(X) - max_ppa) / max(abs(max_ppa), 1e-9)
        return vb + vp

    return viol


def _ppf_from_archive(
    configs: np.ndarray,
    objs_est: np.ndarray,
    viol: np.ndarray,
    max_front: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Feasible estimated-Pareto subset of everything a search evaluated."""
    feas = viol <= 0
    if not feas.any():
        return configs[:0], objs_est[:0]
    c, o = configs[feas], objs_est[feas]
    c, idx = np.unique(c, axis=0, return_index=True)
    o = o[idx]
    mask = pareto_mask(o)
    c, o = c[mask], o[mask]
    if len(c) > max_front:  # cap the synthesis bill, keep extremes + spread
        order = np.argsort(o[:, 0])
        keep = np.unique(np.linspace(0, len(c) - 1, max_front).astype(int))
        c, o = c[order][keep], o[order][keep]
    return c, o


def _validate(
    spec: OperatorSpec,
    configs: np.ndarray,
    settings: DSESettings,
    ref: np.ndarray,
    characterize_fn: Callable[[np.ndarray], np.ndarray],
    max_behav: float,
    max_ppa: float,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Re-characterize PPF configs -> VPF (+ its hypervolume)."""
    if len(configs) == 0:
        return configs, np.zeros((0, 2)), 0.0
    objs = characterize_fn(configs)
    feas = (objs[:, 0] <= max_behav + 1e-9) & (objs[:, 1] <= max_ppa + 1e-9)
    configs, objs = configs[feas], objs[feas]
    if len(configs) == 0:
        return configs, objs, 0.0
    mask = pareto_mask(objs)
    configs, objs = configs[mask], objs[mask]
    return configs, objs, hypervolume_2d(objs, ref)


def _default_characterize(
    spec: OperatorSpec, settings: DSESettings
) -> Callable[[np.ndarray], np.ndarray]:
    def fn(configs: np.ndarray) -> np.ndarray:
        ds = characterize(spec, configs, backend=settings.context)
        return ds.objectives(ppa_key=settings.ppa_key, behav_key=settings.behav_key)

    return fn


def _app_name(app) -> str | None:
    return getattr(app, "name", app) if app is not None else None


def _configs_from_bits(bitstrings: list[str], n_luts: int) -> np.ndarray:
    if not bitstrings:
        return np.zeros((0, n_luts), np.uint8)
    return np.stack([
        np.frombuffer(s.encode("ascii"), np.uint8) - ord("0") for s in bitstrings
    ]).astype(np.uint8)


def _result_from_record(
    rec: dict, method: str, settings: DSESettings, ref: np.ndarray,
    spec: OperatorSpec, t0: float,
) -> DSEResult:
    """Rehydrate a cached front record into a DSEResult (request-cache hit)."""
    return DSEResult(
        method=method,
        settings=settings,
        ppf_configs=_configs_from_bits(rec["ppf_configs"], spec.n_luts),
        ppf_objs_est=np.asarray(rec["ppf_objs"], np.float64).reshape(-1, 2),
        vpf_configs=_configs_from_bits(rec["configs"], spec.n_luts),
        vpf_objs=np.asarray(rec["objs"], np.float64).reshape(-1, 2),
        hv_ppf=float(rec["hv_ppf"]),
        hv_vpf=float(rec["hv"]),
        n_evals=int(rec["n_evals"]),
        wall_s=time.perf_counter() - t0,
        hv_history=[],
        ref_point=ref,
        timings={"store": time.perf_counter() - t0},
    )


def _store_front(store, spec, app_name, st: DSESettings, method: str,
                 res: DSEResult, request: str | None) -> None:
    store.put_front(
        spec, app_name, st.const_sf, st.seed, method,
        res.vpf_configs, res.vpf_objs, res.hv_vpf,
        ppf_configs=res.ppf_configs, ppf_objs=res.ppf_objs_est,
        hv_ppf=res.hv_ppf, n_evals=res.n_evals, request=request,
    )


def _fit(train_ds: Dataset, settings: DSESettings) -> dict[str, AutoMLRegressor]:
    return fit_estimators(
        train_ds.configs.astype(np.float64),
        {
            settings.behav_key: train_ds.metrics[settings.behav_key],
            settings.ppa_key: train_ds.metrics[settings.ppa_key],
        },
        n_quad=settings.n_estimator_quad,
        seed=settings.seed,
    )


def _with_warm(init, warm, limit: int):
    """The GA's seed rows: the MaP pool first, then the library's warm pool."""
    if warm is None or not len(warm):
        return init
    if init is None or not len(init):
        return warm
    return np.concatenate([np.asarray(init), warm])[:limit]


def run_dse(
    spec: OperatorSpec,
    train_ds: Dataset,
    method: str,
    settings: DSESettings | None = None,
    estimators: dict[str, AutoMLRegressor] | None = None,
    map_pool: np.ndarray | None = None,
    characterize_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    ref: np.ndarray | None = None,
    app=None,
    telemetry=None,
    store=None,
) -> DSEResult:
    """One full DSE run (one method, one const_sf).

    ``characterize_fn`` maps (D, L) configs -> (D, 2) true [BEHAV, PPA]; defaults to
    the operator-level exhaustive characterization on the settings' context.
    For application-specific DSE pass an application's objective function, or
    the ``repro_torch.apps`` application itself as ``app``, which builds that
    objective on the settings' context (``settings.behav_key`` must then name
    the app's metric, e.g. ``"APP_MNIST"``, in ``train_ds``).
    Under a torch context the surrogate, the MaP scoring, the GA and the
    validation run on ``context.device``; under a numpy context everything
    is the host oracle.  Per-stage wall clock lands in ``DSEResult.timings``.

    ``telemetry`` (``"on"``/``"off"``/a ``repro_torch.obs.Telemetry``)
    overrides the context's sink for this run; every stage records a span.

    ``store`` (a :class:`repro_torch.service.OperatorStore`) puts the
    persistent operator library behind the run: already-characterized
    configs skip the device validation, a repeated identical request returns
    its cached front without searching, and the GA warm-starts from the
    library's nearest cached fronts.  It is ignored when ``characterize_fn``
    is given (the library is addressed by ``(spec, app)``).  With an empty
    library every path is bit-identical to ``store=None``.
    """
    settings = settings or DSESettings()
    if telemetry is not None:
        settings = dataclasses.replace(
            settings, context=dataclasses.replace(settings.context, telemetry=telemetry))
    ctx = settings.context
    tel = ctx.tel
    if method not in ("ga", "map", "map+ga"):
        raise ValueError(f"unknown method {method!r}")

    t0 = time.perf_counter()
    app_name = _app_name(app)
    store_active = store is not None and characterize_fn is None
    req_key = None
    if store_active:
        from ..service.store import request_key, train_fingerprint

        req_key = request_key(
            spec, app_name, settings.const_sf, settings.seed, method,
            settings, train_fingerprint(train_ds),
        )
        rec = store.lookup_result(req_key)
        if rec is not None:
            ref = hv_reference(train_ds, settings) if ref is None else ref
            return _result_from_record(rec, method, settings, ref, spec, t0)
    timings: dict[str, float] = {}
    with tel.span("dse.run", method=method, backend=ctx.backend,
                  const_sf=settings.const_sf):
        ts = time.perf_counter()
        with tel.span("dse.characterize"):
            if estimators is None:
                estimators = _fit(train_ds, settings)
            if app is not None and characterize_fn is None:
                characterize_fn = app.characterize_fn(
                    spec, ppa_key=settings.ppa_key, backend=ctx)
            characterize_fn = characterize_fn or _default_characterize(spec, settings)
            if store_active:
                characterize_fn = store.cached_characterize(spec, characterize_fn, app_name)
            ref = hv_reference(train_ds, settings) if ref is None else ref
            max_behav, max_ppa = _constraint_bounds(train_ds, settings)

            if ctx.is_torch:
                from .fastchar import compile_surrogate_batch

                eval_viol_fn = compile_surrogate_batch(
                    estimators, settings.behav_key, settings.ppa_key, max_behav, max_ppa,
                    ctx=ctx,
                )
                eval_fn = viol_fn = None
            else:
                eval_viol_fn = None
                eval_fn = _surrogate_eval(estimators, settings)
                viol_fn = _violation_fn(estimators, settings, max_behav, max_ppa)
        timings["characterize"] = time.perf_counter() - ts

        n_evals = 0
        hv_history: list[tuple[int, float]] = []

        if method in ("map", "map+ga") and map_pool is None:
            ts = time.perf_counter()
            with tel.span("dse.map"):
                map_pool = map_solution_pool(spec, train_ds, settings)
            timings["map"] = time.perf_counter() - ts

        ts = time.perf_counter()
        with tel.span("dse.ga"):
            if method == "map":
                pool = map_pool
                if len(pool) == 0:
                    pool = gen_random(spec, 1, seed=settings.seed)  # degenerate fallback
                if ctx.is_torch:
                    objs_est, viol = eval_viol_fn(pool)
                else:
                    objs_est = eval_fn(pool)
                    viol = viol_fn(pool)
                n_evals = len(pool)
                ppf_c, ppf_o = _ppf_from_archive(pool, objs_est, viol)
            else:
                init = map_pool if method == "map+ga" else None
                if store_active:
                    init = _with_warm(init, store.warm_pool(
                        spec, app_name, settings.const_sf, limit=settings.pop_size),
                        settings.pop_size)
                ga: GAResult
                if ctx.is_torch:
                    ga = nsga2(
                        None,
                        n_bits=spec.n_luts,
                        pop_size=settings.pop_size,
                        n_gen=settings.n_gen,
                        seed=settings.seed,
                        initial_population=init,
                        hv_ref=ref,
                        backend=ctx,
                        objs_device_fn=eval_viol_fn.objs_fn,
                        max_behav=max_behav,
                        max_ppa=max_ppa,
                    )
                else:
                    ga = nsga2(
                        eval_fn,
                        n_bits=spec.n_luts,
                        pop_size=settings.pop_size,
                        n_gen=settings.n_gen,
                        seed=settings.seed,
                        initial_population=init,
                        violation_fn=viol_fn,
                        hv_ref=ref,
                        backend=ctx,
                    )
                n_evals = len(ga.archive_configs)
                hv_history = ga.hv_history
                ppf_c, ppf_o = _ppf_from_archive(
                    ga.archive_configs, ga.archive_objs, ga.archive_viol
                )
            hv_ppf = hypervolume_2d(ppf_o, ref) if len(ppf_o) else 0.0
        timings["ga"] = time.perf_counter() - ts

        ts = time.perf_counter()
        with tel.span("dse.validate"):
            vpf_c, vpf_o, hv_vpf = _validate(
                spec, ppf_c, settings, ref, characterize_fn, max_behav, max_ppa
            )
        timings["validate"] = time.perf_counter() - ts
    result = DSEResult(
        method=method,
        settings=settings,
        ppf_configs=ppf_c,
        ppf_objs_est=ppf_o,
        vpf_configs=vpf_c,
        vpf_objs=vpf_o,
        hv_ppf=hv_ppf,
        hv_vpf=hv_vpf,
        n_evals=n_evals,
        wall_s=time.perf_counter() - t0,
        hv_history=hv_history,
        ref_point=ref,
        timings=timings,
    )
    if store_active:
        _store_front(store, spec, app_name, settings, method, result, req_key)
    return result


def run_dse_sweep(
    spec: OperatorSpec,
    train_ds: Dataset,
    method: str = "ga",
    settings: DSESettings | None = None,
    seeds=(0,),
    const_sf_grid=None,
    estimators: dict[str, AutoMLRegressor] | None = None,
    characterize_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    app=None,
    store=None,
    telemetry=None,
) -> list[DSEResult]:
    """A (seeds x const_sf) restart/constraint grid as ONE batched GA.

    Calling ``run_dse`` once per (seed, const_sf) fits the estimators and runs
    the GA once a lane; here the estimators are fitted once, the MaP pools
    solved once per const_sf for ``method="map+ga"`` (each battery's tabu
    starts scored together, ``fastchar.tabu_neighbor_values_multi``), and
    every lane runs in one ``fastmoo.CompiledNSGA2.run_sweep``, ranked by one
    launch of K3 over all lanes a ranking.  Validation is per lane.  Lane
    order: ``for const_sf in const_sf_grid: for seed in seeds``; lane (seed,
    const_sf) equals ``run_dse`` at that seed and const_sf.  Requires the
    torch backend.

    ``store`` puts the operator library behind the sweep: lanes whose exact
    request was served before are answered from the cache and dropped from
    the GA, the other lanes warm-start from the library's nearest fronts,
    and validation skips already-characterized configs.  As in
    :func:`run_dse`, a caller's ``characterize_fn`` disables it, and an
    empty library is bit-identical to ``store=None``.
    """
    from .fastchar import surrogate_objs_device
    from .fastmoo import CompiledNSGA2

    settings = settings or DSESettings()
    if telemetry is not None:
        settings = dataclasses.replace(
            settings, context=dataclasses.replace(settings.context, telemetry=telemetry))
    ctx = settings.context
    tel = ctx.tel
    if not ctx.is_torch:
        raise ValueError("run_dse_sweep runs the device GA: it needs the torch backend")
    if method not in ("ga", "map+ga"):
        raise ValueError(f"unsupported sweep method {method!r}")
    t0 = time.perf_counter()
    app_name = _app_name(app)
    store_active = store is not None and characterize_fn is None
    fingerprint = None
    if store_active:
        from ..service.store import request_key, train_fingerprint

        fingerprint = train_fingerprint(train_ds)
    const_sf_grid = (settings.const_sf,) if const_sf_grid is None else tuple(const_sf_grid)
    lane_settings = [dataclasses.replace(settings, const_sf=sf, seed=int(seed))
                     for sf in const_sf_grid for seed in seeds]
    req_keys: list[str | None] = [None] * len(lane_settings)
    cached: list[dict | None] = [None] * len(lane_settings)   # request-cache hits
    if store_active:
        for i, st in enumerate(lane_settings):
            req_keys[i] = request_key(spec, app_name, st.const_sf, st.seed, method,
                                      settings, fingerprint)
            cached[i] = store.lookup_result(req_keys[i])
    live_sf = {st.const_sf for st, rec in zip(lane_settings, cached) if rec is None}
    shared: dict[str, float] = {}
    with tel.span("dse.sweep", method=method, n_sf=len(const_sf_grid),
                  n_seeds=len(seeds)):
        ts = time.perf_counter()
        with tel.span("dse.characterize"):
            # a sweep answered wholly from the library fits nothing
            if estimators is None and live_sf:
                estimators = _fit(train_ds, settings)
            if app is not None and characterize_fn is None:
                characterize_fn = app.characterize_fn(
                    spec, ppa_key=settings.ppa_key, backend=ctx)
            characterize_fn = characterize_fn or _default_characterize(spec, settings)
            if store_active:
                characterize_fn = store.cached_characterize(spec, characterize_fn, app_name)
            ref = hv_reference(train_ds, settings)
        shared["characterize"] = time.perf_counter() - ts

        bounds: dict[float, tuple[float, float]] = {}
        pools: dict[float, object] = {}
        ts = time.perf_counter()
        with tel.span("dse.map" if method == "map+ga" else "dse.lanes"):
            for sf in const_sf_grid:
                st_sf = dataclasses.replace(settings, const_sf=sf)
                bounds[sf] = _constraint_bounds(train_ds, st_sf)
                if sf not in live_sf:
                    continue   # every lane of this const_sf is answered from the library
                pool = map_solution_pool(spec, train_ds, st_sf) if method == "map+ga" else None
                warm = (store.warm_pool(spec, app_name, sf, limit=settings.pop_size)
                        if store_active else None)
                # the MaP pool first, then the library's warm pool, as run_dse
                # seeds its GA
                pools[sf] = _with_warm(pool, warm, settings.pop_size)
        if method == "map+ga":
            shared["map"] = time.perf_counter() - ts

        # lanes answered by the request cache drop out of the GA
        live = [i for i, rec in enumerate(cached) if rec is None]
        ts = time.perf_counter()
        gas: list = [None] * len(lane_settings)
        with tel.span("dse.ga", n_lanes=len(live)):
            if live:
                runner = CompiledNSGA2(
                    surrogate_objs_device(estimators, settings.behav_key, settings.ppa_key,
                                          ctx.device),
                    n_bits=spec.n_luts,
                    pop_size=settings.pop_size,
                    n_gen=settings.n_gen,
                    hv_ref=ref,
                    ctx=ctx,
                )
                live_gas = runner.run_sweep(
                    [lane_settings[i].seed for i in live],
                    [bounds[lane_settings[i].const_sf] for i in live],
                    [pools[lane_settings[i].const_sf] for i in live],
                )
                for i, ga in zip(live, live_gas):
                    gas[i] = ga
        shared["ga"] = time.perf_counter() - ts

        results: list[DSEResult] = []
        with tel.span("dse.validate", n_lanes=len(live)):
            for i, (st, ga) in enumerate(zip(lane_settings, gas)):
                if ga is None:   # request-cache hit: rehydrate, no search
                    results.append(_result_from_record(cached[i], method, st, ref, spec, t0))
                    continue
                mb, mp = bounds[st.const_sf]
                tv = time.perf_counter()
                ppf_c, ppf_o = _ppf_from_archive(
                    ga.archive_configs, ga.archive_objs, ga.archive_viol)
                hv_ppf = hypervolume_2d(ppf_o, ref) if len(ppf_o) else 0.0
                vpf_c, vpf_o, hv_vpf = _validate(spec, ppf_c, st, ref, characterize_fn, mb, mp)
                # the shared stages ran once for the sweep; validation is per lane
                timings = dict(shared, validate=time.perf_counter() - tv)
                res = DSEResult(
                    method=method,
                    settings=st,
                    ppf_configs=ppf_c,
                    ppf_objs_est=ppf_o,
                    vpf_configs=vpf_c,
                    vpf_objs=vpf_o,
                    hv_ppf=hv_ppf,
                    hv_vpf=hv_vpf,
                    n_evals=len(ga.archive_configs),
                    wall_s=time.perf_counter() - t0,
                    hv_history=ga.hv_history,
                    ref_point=ref,
                    timings=timings,
                )
                if store_active:
                    _store_front(store, spec, app_name, st, method, res, req_keys[i])
                results.append(res)
    return results


def fixed_library(spec: OperatorSpec, n_random_fixed: int = 64) -> np.ndarray:
    """EvoApprox-style frozen design library (no search, ASIC-derived heuristics).

    Classic truncation schemes + whole-row removals + a small frozen random set:
    the library is independent of the DSE problem, so under tight constraints many
    (or all) members are infeasible -- exactly the failure mode the paper reports
    for EvoApprox designs on FPGAs (Figs. 14, 17-19).
    """
    L = spec.n_luts
    cpr = spec.cols_removable
    rows: list[np.ndarray] = [np.ones(L, dtype=np.uint8)]

    # Uniform per-row LSB truncation (classic truncated multiplier ladder).
    for j in range(1, cpr + 1):
        c = np.ones(L, dtype=np.uint8)
        for r in range(spec.rows):
            c[r * cpr : r * cpr + j] = 0
        rows.append(c)
    # Diagonal truncation: row r loses j - 2r columns (column-weight aligned).
    for j in range(1, cpr + 1):
        c = np.ones(L, dtype=np.uint8)
        for r in range(spec.rows):
            k = max(0, j - 2 * r)
            c[r * cpr : r * cpr + k] = 0
        rows.append(c)
    # Whole-row removals.
    for r in range(spec.rows):
        c = np.ones(L, dtype=np.uint8)
        c[r * cpr : (r + 1) * cpr] = 0
        rows.append(c)
    # Frozen random members (seeded: the library never changes between problems).
    rng = np.random.default_rng(1234)
    rows.extend(rng.integers(0, 2, size=(n_random_fixed, L)).astype(np.uint8))

    out = np.stack(rows)
    _, idx = np.unique(out, axis=0, return_index=True)
    return out[np.sort(idx)]
