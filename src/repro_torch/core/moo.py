"""Multi-objective optimization utilities: Pareto fronts, hypervolume, NSGA-II.

The GA matches the paper's setup (§4.3.2): binary chromosomes, tournament
selection, single-point crossover, bit-flip mutation, up to 250 generations, with
constraint-domination (feasibility-first) handling of the ``const_sf`` bounds.
``initial_population`` is how MaP augmentation enters (paper Fig. 6): MaP solutions
are injected alongside random configs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

__all__ = [
    "pareto_mask",
    "hypervolume_2d",
    "fast_nondominated_sort",
    "crowding_distance",
    "nsga2",
    "GAResult",
]


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows (all objectives minimized)."""
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    mask = np.ones(n, dtype=bool)
    order = np.lexsort(pts.T[::-1])  # sort by first objective, then others
    pts_sorted = pts[order]
    if pts.shape[1] == 2:
        best_y = np.inf
        for rank, i in enumerate(order):
            y = pts_sorted[rank, 1]
            if y < best_y:
                best_y = y
            else:
                mask[i] = False  # weakly dominated by an earlier (<= x, <= y) point
        return mask
    for i in range(n):
        if not mask[i]:
            continue
        dominated = np.all(pts <= pts[i], axis=1) & np.any(pts < pts[i], axis=1)
        if dominated.any():
            mask[i] = False
    return mask


def hypervolume_2d(points: np.ndarray, ref: np.ndarray) -> float:
    """Exact 2-D hypervolume (minimization) w.r.t. reference point ``ref``."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
    ref = np.asarray(ref, dtype=np.float64)
    pts = pts[np.all(pts <= ref, axis=1)]
    if pts.size == 0:
        return 0.0
    pts = pts[pareto_mask(pts)]
    pts = pts[np.argsort(pts[:, 0])]
    hv = 0.0
    prev_y = ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)


def fast_nondominated_sort(objs: np.ndarray, feas_viol: np.ndarray | None = None) -> np.ndarray:
    """Rank (0 = best front) with constraint domination: any feasible point
    dominates any infeasible one; infeasible points compare by violation."""
    n = objs.shape[0]
    if feas_viol is None:
        feas_viol = np.zeros(n)
    rank = np.full(n, -1, dtype=np.int64)

    dom = np.zeros((n, n), dtype=bool)
    le = (objs[:, None, :] <= objs[None, :, :]).all(-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(-1)
    obj_dom = le & lt
    fi = feas_viol <= 0
    both_feas = fi[:, None] & fi[None, :]
    both_infeas = ~fi[:, None] & ~fi[None, :]
    dom |= both_feas & obj_dom
    dom |= fi[:, None] & ~fi[None, :]
    dom |= both_infeas & (feas_viol[:, None] < feas_viol[None, :])

    n_dominators = dom.sum(axis=0)
    current = np.where(n_dominators == 0)[0]
    r = 0
    remaining = n_dominators.copy()
    assigned = np.zeros(n, dtype=bool)
    while current.size:
        rank[current] = r
        assigned[current] = True
        for i in current:
            remaining[dom[i]] -= 1
        current = np.where((remaining == 0) & ~assigned)[0]
        r += 1
    return rank


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    n, m = objs.shape
    dist = np.zeros(n)
    if n <= 2:
        return np.full(n, np.inf)
    for k in range(m):
        order = np.argsort(objs[:, k])
        dist[order[0]] = dist[order[-1]] = np.inf
        span = objs[order[-1], k] - objs[order[0], k]
        if span <= 0:
            continue
        dist[order[1:-1]] += (objs[order[2:], k] - objs[order[:-2], k]) / span
    return dist


@dataclass
class GAResult:
    population: np.ndarray                 # (P, L) final population
    objectives: np.ndarray                 # (P, 2)
    archive_configs: np.ndarray            # all evaluated configs
    archive_objs: np.ndarray
    archive_viol: np.ndarray
    hv_history: list[tuple[int, float]] = field(default_factory=list)
    # (fitness evaluations, hypervolume of feasible archive pareto front)


def nsga2(
    eval_fn: Callable[[np.ndarray], np.ndarray] | None,
    n_bits: int,
    pop_size: int = 64,
    n_gen: int = 250,
    seed: int = 0,
    initial_population: np.ndarray | None = None,
    violation_fn: Callable[[np.ndarray], np.ndarray] | None = None,
    hv_ref: np.ndarray | None = None,
    crossover_p: float = 0.9,
    mutation_p: float | None = None,
    eval_viol_fn: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray]] | None = None,
    backend=None,
    objs_device_fn: Callable | None = None,
    max_behav: float | None = None,
    max_ppa: float | None = None,
) -> GAResult:
    """NSGA-II for binary chromosomes; ``eval_fn`` maps (B, L) -> (B, n_obj).

    ``eval_viol_fn`` is the batched fast path: a single callable returning
    ``(objectives, violations)`` for a whole generation, letting a device
    surrogate (``repro_torch.core.fastchar.compile_surrogate_batch``) evaluate
    each generation in one call.  When given it replaces both ``eval_fn`` and
    ``violation_fn``.

    ``backend`` is a string or an ``ExecutionContext``.  ``"torch"`` (the
    default, on the card) runs the
    *whole* GA -- operators, sorting, environmental selection, archive
    hypervolume -- on the context's device (``repro_torch.core.fastmoo``).  It
    requires ``objs_device_fn``, a ``(B, L) -> (B, 2)`` f32 tensor objective
    closure (e.g. ``fastchar.surrogate_objs_device`` or the ``.objs_fn``
    attribute of ``compile_surrogate_batch``'s result), with optional
    constraint bounds ``max_behav``/``max_ppa`` (the normalized-overflow
    violation used by the DSE layer).  RNG streams differ from numpy's, so
    results match the numpy oracle in hypervolume, not bit-for-bit.
    """
    from .engine import as_context

    ctx = as_context(backend)
    if ctx.is_torch:
        from .fastmoo import UNBOUNDED, nsga2_torch

        if objs_device_fn is None:
            raise ValueError("backend='torch' requires objs_device_fn")
        if violation_fn is not None or eval_viol_fn is not None:
            raise ValueError(
                "backend='torch' evaluates constraints on the device: pass "
                "max_behav/max_ppa bounds instead of violation_fn/eval_viol_fn"
            )
        return nsga2_torch(
            objs_device_fn,
            n_bits=n_bits,
            pop_size=pop_size,
            n_gen=n_gen,
            seed=seed,
            initial_population=initial_population,
            hv_ref=hv_ref,
            crossover_p=crossover_p,
            mutation_p=mutation_p,
            max_behav=UNBOUNDED if max_behav is None else max_behav,
            max_ppa=UNBOUNDED if max_ppa is None else max_ppa,
            ctx=ctx,
        )
    rng = np.random.default_rng(seed)
    mutation_p = mutation_p if mutation_p is not None else 1.0 / n_bits
    if eval_fn is None and eval_viol_fn is None:
        raise ValueError("one of eval_fn / eval_viol_fn is required")

    pop = rng.integers(0, 2, size=(pop_size, n_bits)).astype(np.uint8)
    if initial_population is not None and len(initial_population):
        k = min(len(initial_population), pop_size)
        pop[:k] = initial_population[:k]

    def evaluate(P):
        if eval_viol_fn is not None:
            objs, viol = eval_viol_fn(P)
            return (
                np.asarray(objs, dtype=np.float64),
                np.asarray(viol, dtype=np.float64),
            )
        objs = np.asarray(eval_fn(P), dtype=np.float64)
        viol = (
            np.asarray(violation_fn(P), dtype=np.float64)
            if violation_fn is not None
            else np.zeros(len(P))
        )
        return objs, viol

    objs, viol = evaluate(pop)
    arc_c, arc_o, arc_v = [pop.copy()], [objs.copy()], [viol.copy()]
    n_evals = pop_size
    hv_hist: list[tuple[int, float]] = []

    def record_hv():
        if hv_ref is None:
            return
        ac = np.concatenate(arc_o)
        av = np.concatenate(arc_v)
        feas = av <= 0
        hv = hypervolume_2d(ac[feas], hv_ref) if feas.any() else 0.0
        hv_hist.append((n_evals, hv))

    record_hv()

    for gen in range(n_gen):
        rank = fast_nondominated_sort(objs, viol)
        crowd = np.zeros(pop_size)
        for r in np.unique(rank):
            idx = np.where(rank == r)[0]
            crowd[idx] = crowding_distance(objs[idx])

        # binary tournament selection
        cand = rng.integers(0, pop_size, size=(pop_size, 2))
        a, b = cand[:, 0], cand[:, 1]
        better = (rank[a] < rank[b]) | ((rank[a] == rank[b]) & (crowd[a] > crowd[b]))
        parents = np.where(better, a, b)

        # single-point crossover
        children = pop[parents].copy()
        for i in range(0, pop_size - 1, 2):
            if rng.random() < crossover_p:
                cut = rng.integers(1, n_bits)
                tmp = children[i, cut:].copy()
                children[i, cut:] = children[i + 1, cut:]
                children[i + 1, cut:] = tmp
        # bit-flip mutation
        flip = rng.random(children.shape) < mutation_p
        children = children ^ flip.astype(np.uint8)

        c_objs, c_viol = evaluate(children)
        n_evals += pop_size
        arc_c.append(children.copy())
        arc_o.append(c_objs.copy())
        arc_v.append(c_viol.copy())

        # environmental selection on combined population
        all_pop = np.concatenate([pop, children])
        all_objs = np.concatenate([objs, c_objs])
        all_viol = np.concatenate([viol, c_viol])
        all_rank = fast_nondominated_sort(all_objs, all_viol)
        order = []
        for r in np.unique(all_rank):
            idx = np.where(all_rank == r)[0]
            if len(order) + len(idx) <= pop_size:
                order.extend(idx.tolist())
            else:
                cd = crowding_distance(all_objs[idx])
                keep = idx[np.argsort(-cd)][: pop_size - len(order)]
                order.extend(keep.tolist())
                break
        sel = np.array(order[:pop_size])
        pop, objs, viol = all_pop[sel], all_objs[sel], all_viol[sel]
        if gen % 10 == 9 or gen == n_gen - 1:
            record_hv()

    return GAResult(
        population=pop,
        objectives=objs,
        archive_configs=np.concatenate(arc_c),
        archive_objs=np.concatenate(arc_o),
        archive_viol=np.concatenate(arc_v),
        hv_history=hv_hist,
    )
