"""MILP / MIQCP formulation and solvers (AxOMaP §4.2-4.3.1).

A MaP problem over binary LUT variables ``l`` (paper Eqs. 3-8):

    minimize    wt_B * v_behav + (1 - wt_B) * v_ppa
    subject to  v_behav <= max_behav,   v_ppa <= max_ppa,   l_i in {0, 1}

where ``v_ppa``/``v_behav`` are polynomial-regression expressions (linear -> MILP;
with correlation-ranked quadratic terms -> MIQCP), and the bounds come from
``const_sf`` scaling of the training-set maxima (Eq. 8).

The paper uses a commercial MIQCP solver; none is available offline, so three
solvers with the same contract (best feasible point + a pool of good feasible
points -- the paper consumes solution *pools*, not certified optima):

  * ``solve_enumerate`` -- exact, fully vectorized, for L <= 22 (covers the 4x4
    operator's 2^10 space exhaustively).
  * ``solve_bnb``       -- depth-first branch-and-bound with partial-fix bounds;
    exact on MILP given budget, anytime otherwise.
  * ``solve_tabu``      -- multi-start steepest-descent tabu search with adaptive
    constraint penalties, for the 8x8 operator's L = 36 MIQCPs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .engine import as_context
from .regression import PolyRegModel

__all__ = [
    "QuadExpr",
    "MapProblem",
    "build_problems",
    "solve",
    "solve_enumerate",
    "solve_bnb",
    "solve_tabu",
    "solve_tabu_multi",
    "solve_pool",
]


@dataclass
class QuadExpr:
    """c + b.l + l'Q l  with Q upper-triangular (i < j) plus diagonal folded into b."""

    const: float
    lin: np.ndarray                   # (L,)
    quad: np.ndarray                  # (L, L) upper-triangular, zero diagonal

    @staticmethod
    def from_model(model: PolyRegModel) -> "QuadExpr":
        L = model.n_features
        const, lin, quads = model.map_terms()
        lin = lin.astype(np.float64).copy()
        Q = np.zeros((L, L))
        for i, j, c in quads:
            if i == j:
                # l_i^2 == l_i for binaries (paper notes this folding)
                lin[i] += c
            else:
                a, b = min(i, j), max(i, j)
                Q[a, b] += c
        return QuadExpr(const=float(const), lin=lin, quad=Q)

    @property
    def n(self) -> int:
        return self.lin.shape[0]

    def value(self, l: np.ndarray) -> np.ndarray:
        """Evaluate on (..., L) binary array."""
        l = np.asarray(l, dtype=np.float64)
        lin_term = l @ self.lin
        quad_term = np.einsum("...i,ij,...j->...", l, self.quad, l)
        return self.const + lin_term + quad_term

    def flip_deltas(self, l: np.ndarray) -> np.ndarray:
        """Change in value for flipping each bit of a single config l (L,)."""
        l = np.asarray(l, dtype=np.float64)
        sym = self.quad + self.quad.T
        grad = self.lin + sym @ l
        return (1.0 - 2.0 * l) * grad

    def lower_bound_free(self, fixed_mask: np.ndarray, fixed_val: np.ndarray) -> float:
        """Cheap lower bound with some variables fixed (for branch and bound)."""
        l0 = np.where(fixed_mask, fixed_val, 0.0)
        base = self.value(l0)
        sym = self.quad + self.quad.T
        # Contribution of each free variable if set to 1, taking only negative
        # interactions with other FREE variables (optimistic).
        free = ~fixed_mask
        inter_fixed = sym @ l0
        neg_free_inter = np.where(free[None, :], np.minimum(sym, 0.0), 0.0).sum(axis=1)
        gain = self.lin + inter_fixed + neg_free_inter
        return float(base + np.minimum(gain, 0.0)[free].sum())


@dataclass
class MapProblem:
    """One scalarized, constrained MaP instance."""

    obj: QuadExpr
    behav: QuadExpr
    ppa: QuadExpr
    max_behav: float
    max_ppa: float
    wt_b: float
    const_sf: float
    n_quad: int
    meta: dict = field(default_factory=dict)

    @property
    def n(self) -> int:
        return self.obj.n

    def feasible(self, l: np.ndarray) -> np.ndarray:
        return (self.behav.value(l) <= self.max_behav + 1e-9) & (
            self.ppa.value(l) <= self.max_ppa + 1e-9
        )

    def violation(self, l: np.ndarray) -> np.ndarray:
        vb = np.maximum(0.0, self.behav.value(l) - self.max_behav)
        vp = np.maximum(0.0, self.ppa.value(l) - self.max_ppa)
        return vb / max(abs(self.max_behav), 1e-9) + vp / max(abs(self.max_ppa), 1e-9)


def build_problems(
    behav_model: PolyRegModel,
    ppa_model: PolyRegModel,
    behav_max: float,
    ppa_max: float,
    const_sf: float,
    wt_grid: np.ndarray | None = None,
    n_quad: int | None = None,
) -> list[MapProblem]:
    """The paper's wt_B sweep (0 -> 1 step 0.05) for one (const_sf, #quad) setting.

    ``behav_max`` / ``ppa_max`` are in *original* units; they are mapped through the
    models' MinMax scalers since expressions live in scaled space (Eq. 8).
    """
    if wt_grid is None:
        wt_grid = np.arange(0.0, 1.0001, 0.05)
    b_expr = QuadExpr.from_model(behav_model)
    p_expr = QuadExpr.from_model(ppa_model)
    maxb = behav_model.scaler.transform(np.array([const_sf * behav_max]))[0]
    maxp = ppa_model.scaler.transform(np.array([const_sf * ppa_max]))[0]
    problems = []
    for wt in wt_grid:
        obj = QuadExpr(
            const=wt * b_expr.const + (1 - wt) * p_expr.const,
            lin=wt * b_expr.lin + (1 - wt) * p_expr.lin,
            quad=wt * b_expr.quad + (1 - wt) * p_expr.quad,
        )
        problems.append(
            MapProblem(
                obj=obj,
                behav=b_expr,
                ppa=p_expr,
                max_behav=float(maxb),
                max_ppa=float(maxp),
                wt_b=float(wt),
                const_sf=float(const_sf),
                n_quad=int(n_quad if n_quad is not None else len(behav_model.quad_pairs)),
            )
        )
    return problems


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------


@dataclass
class SolveResult:
    best: np.ndarray | None           # (L,) uint8 or None if infeasible
    best_obj: float
    pool: np.ndarray                  # (P, L) uint8 feasible pool (may be empty)
    solver: str


def _all_configs(L: int) -> np.ndarray:
    codes = np.arange(1 << L, dtype=np.uint64)
    out = np.zeros((codes.size, L), dtype=np.uint8)
    for j in range(L):
        out[:, j] = (codes >> np.uint64(j)) & np.uint64(1)
    return out


def solve_enumerate(
    problem: MapProblem, pool_size: int = 16, backend=None
) -> SolveResult:
    """Exact vectorized enumeration; only for L <= 22.

    ``backend`` is a string or an ``ExecutionContext``; under the torch
    backend (the default, on the card) all 2^L configs (objective + both constraint expressions) are
    scored in one batched evaluation on the context's device
    (``fastchar.map_problem_values``); selection stays on the host.  Values
    are float32 on that path, so near-ties may order differently than numpy.
    """
    ctx = as_context(backend)
    use_dev = ctx.is_torch
    L = problem.n
    if L > 22:
        raise ValueError(f"enumeration infeasible for L={L}")
    cfgs = _all_configs(L)
    if use_dev:
        from .fastchar import map_problem_values

        objs, vb, vp = map_problem_values(problem, cfgs, device=ctx.device)
        feas = (vb <= problem.max_behav + 1e-9) & (vp <= problem.max_ppa + 1e-9)
    else:
        feas = problem.feasible(cfgs)
        objs = problem.obj.value(cfgs)
    if not feas.any():
        return SolveResult(None, np.inf, np.empty((0, L), dtype=np.uint8), "enum")
    objs = np.where(feas, objs, np.inf)
    order = np.argsort(objs)[: 2 * pool_size if use_dev else pool_size]
    order = order[np.isfinite(objs[order])]
    if use_dev:
        # f32 scoring can misclassify configs within ~1e-6 of a bound; the pool
        # contract is float64 feasibility, so re-validate the few selected and
        # report the float64 objective of the winner.
        order = order[problem.feasible(cfgs[order])][:pool_size]
        if order.size == 0:
            return SolveResult(None, np.inf, np.empty((0, L), dtype=np.uint8), "enum")
        best_obj = float(problem.obj.value(cfgs[order[0]]))
        return SolveResult(cfgs[order[0]], best_obj, cfgs[order], "enum")
    return SolveResult(cfgs[order[0]], float(objs[order[0]]), cfgs[order], "enum")


def _tabu_starts(problem: MapProblem, n_starts: int, seed: int) -> list[np.ndarray]:
    """The shared multi-start battery: all-ones, all-zeros, then seeded random."""
    L = problem.n
    rng = np.random.default_rng(seed)
    starts = [np.ones(L, dtype=np.float64), np.zeros(L, dtype=np.float64)]
    while len(starts) < n_starts:
        starts.append(rng.integers(0, 2, L).astype(np.float64))
    return starts


def _tabu_pool_result(
    pool: list[tuple[float, bytes]],
    best: np.ndarray | None,
    best_obj: float,
    pool_size: int,
    L: int,
) -> SolveResult:
    if best is None:
        return SolveResult(None, np.inf, np.empty((0, L), dtype=np.uint8), "tabu")
    seen: dict[bytes, float] = {}
    for obj, key in sorted(pool):
        if key not in seen:
            seen[key] = obj
        if len(seen) >= pool_size:
            break
    pool_arr = np.stack(
        [np.frombuffer(k, dtype=np.uint8) for k in seen]
    ) if seen else np.empty((0, L), dtype=np.uint8)
    return SolveResult(best, best_obj, pool_arr, "tabu")


def _solve_tabu_torch(
    problem: MapProblem,
    n_starts: int,
    n_iters: int,
    tabu_tenure: int,
    pool_size: int,
    seed: int,
    device: str,
) -> SolveResult:
    """Lockstep multi-start tabu: every start's full single-flip neighborhood
    scored per iteration in ONE device evaluation (``fastchar.
    tabu_neighbor_values``, the same batched quadratic form that
    ``solve_enumerate(backend="torch")`` uses).

    Same starts, operators, penalties and stopping rules as the numpy path,
    but starts advance together instead of serially, so the shared aspiration
    threshold sees cross-start bests in *iteration* order rather than start
    order, and neighborhood scoring is f32 (feasibility/pool bookkeeping is
    re-validated in host float64, like the enumerate torch path).  The
    returned pool matches numpy's in feasibility and objective quality;
    membership can differ on near-ties.
    """
    from .fastchar import tabu_neighbor_values

    L = problem.n
    states = np.stack(_tabu_starts(problem, n_starts, seed))      # (S, L)
    S = len(states)
    step = tabu_neighbor_values(problem, device=device)
    den_b = max(abs(problem.max_behav), 1e-9)
    den_p = max(abs(problem.max_ppa), 1e-9)

    rho = np.ones(S)
    tabu = np.zeros((S, L), dtype=np.int64)
    active = np.ones(S, dtype=bool)
    cur_pen = problem.obj.value(states) + rho * problem.violation(states)
    pool: list[tuple[float, bytes]] = []
    best, best_obj = None, np.inf

    for it in range(n_iters):
        if not active.any():
            break
        vals, deltas = step(states)
        obj_v, vb, vp = vals
        d_obj, d_b, d_p = deltas
        nb = np.maximum(0.0, vb[:, None] + d_b - problem.max_behav) / den_b
        np_ = np.maximum(0.0, vp[:, None] + d_p - problem.max_ppa) / den_p
        cand_pen = obj_v[:, None] + d_obj + rho[:, None] * (nb + np_)
        blocked = tabu > it
        asp = (cand_pen < best_obj) & (nb + np_ <= 0)
        score = np.where(blocked & ~asp, np.inf, cand_pen)
        k = np.argmin(score, axis=1)
        k_score = score[np.arange(S), k]
        active &= np.isfinite(k_score)
        rows = np.where(active)[0]
        if rows.size == 0:
            break
        move_gain = cur_pen - k_score
        states[rows, k[rows]] = 1.0 - states[rows, k[rows]]
        tabu[rows, k[rows]] = it + tabu_tenure
        cur_pen = np.where(active, k_score, cur_pen)

        # float64 bookkeeping of the moved states (feasibility, pool, best)
        viol_new = problem.violation(states[rows])
        obj_new = problem.obj.value(states[rows])
        for ri, v, o in zip(rows, viol_new, obj_new):
            if v <= 0:
                key = states[ri].astype(np.uint8).tobytes()
                pool.append((float(o), key))
                if o < best_obj:
                    best_obj, best = float(o), states[ri].astype(np.uint8).copy()
            else:
                rho[ri] *= 1.05
        brk = (move_gain[rows] <= 1e-12) & (it > 20) & (rho[rows] > 100)
        active[rows[brk]] = False

    return _tabu_pool_result(pool, best, best_obj, pool_size, L)


def solve_tabu_multi(
    problems: list[MapProblem],
    seeds,
    n_starts: int = 8,
    n_iters: int = 400,
    tabu_tenure: int = 7,
    pool_size: int = 16,
    backend="torch",
) -> list[SolveResult]:
    """Cross-problem lockstep tabu: one device evaluation per iteration scores
    EVERY problem's every start's full single-flip neighborhood.

    The whole battery (wt_B x n_quad x const_sf) advances as a single
    (problems x starts, L) batch through the batched scorer
    ``fastchar.tabu_neighbor_values_multi`` on the device of ``backend`` (a
    string or an ``ExecutionContext``).  Problems are fully independent
    (per-problem penalties, aspiration thresholds, pools), so each problem's
    trajectory matches ``_solve_tabu_torch`` run alone, modulo f32 summation
    order inside the batched einsum.  ``seeds`` gives each problem its own
    start battery, matching ``solve_pool``'s ``seed + k``.
    """
    from .fastchar import tabu_neighbor_values_multi

    if not problems:
        return []
    L = problems[0].n
    if any(p.n != L for p in problems):
        raise ValueError("solve_tabu_multi requires a same-L problem battery")
    seeds = list(seeds)
    if len(seeds) != len(problems):
        raise ValueError(f"{len(problems)} problems but {len(seeds)} seeds")
    P = len(problems)
    states = np.stack(
        [np.stack(_tabu_starts(pb, n_starts, sd)) for pb, sd in zip(problems, seeds)]
    )  # (P, S, L)
    S = states.shape[1]
    step = tabu_neighbor_values_multi(problems, device=as_context(backend).device)
    max_b = np.array([pb.max_behav for pb in problems])[:, None, None]
    max_p = np.array([pb.max_ppa for pb in problems])[:, None, None]
    den_b = np.maximum(np.abs(max_b), 1e-9)
    den_p = np.maximum(np.abs(max_p), 1e-9)

    rho = np.ones((P, S))
    tabu = np.zeros((P, S, L), dtype=np.int64)
    active = np.ones((P, S), dtype=bool)
    cur_pen = np.stack(
        [pb.obj.value(states[p]) + rho[p] * pb.violation(states[p])
         for p, pb in enumerate(problems)]
    )
    pools: list[list[tuple[float, bytes]]] = [[] for _ in range(P)]
    bests: list[np.ndarray | None] = [None] * P
    best_obj = np.full(P, np.inf)

    for it in range(n_iters):
        if not active.any():
            break
        vals, deltas = step(states)                       # (P, 3, S), (P, 3, S, L)
        obj_v, vb, vp = vals[:, 0], vals[:, 1], vals[:, 2]
        d_obj, d_b, d_p = deltas[:, 0], deltas[:, 1], deltas[:, 2]
        nb = np.maximum(0.0, vb[:, :, None] + d_b - max_b) / den_b
        np_ = np.maximum(0.0, vp[:, :, None] + d_p - max_p) / den_p
        cand_pen = obj_v[:, :, None] + d_obj + rho[:, :, None] * (nb + np_)
        blocked = tabu > it
        asp = (cand_pen < best_obj[:, None, None]) & (nb + np_ <= 0)
        score = np.where(blocked & ~asp, np.inf, cand_pen)
        k = np.argmin(score, axis=2)                      # (P, S)
        k_score = np.take_along_axis(score, k[:, :, None], axis=2)[:, :, 0]
        active &= np.isfinite(k_score)
        pi, si = np.nonzero(active)
        if pi.size == 0:
            break
        move_gain = cur_pen - k_score
        states[pi, si, k[pi, si]] = 1.0 - states[pi, si, k[pi, si]]
        tabu[pi, si, k[pi, si]] = it + tabu_tenure
        cur_pen = np.where(active, k_score, cur_pen)

        # float64 bookkeeping of the moved states (feasibility, pool, best),
        # per problem in start order -- identical to the single-problem path
        for p in range(P):
            rows = si[pi == p]
            if rows.size == 0:
                continue
            pb = problems[p]
            viol_new = pb.violation(states[p, rows])
            obj_new = pb.obj.value(states[p, rows])
            for ri, v, o in zip(rows, viol_new, obj_new):
                if v <= 0:
                    key = states[p, ri].astype(np.uint8).tobytes()
                    pools[p].append((float(o), key))
                    if o < best_obj[p]:
                        best_obj[p] = float(o)
                        bests[p] = states[p, ri].astype(np.uint8).copy()
                else:
                    rho[p, ri] *= 1.05
        brk = (move_gain[pi, si] <= 1e-12) & (it > 20) & (rho[pi, si] > 100)
        active[pi[brk], si[brk]] = False

    return [
        _tabu_pool_result(pools[p], bests[p], best_obj[p], pool_size, L)
        for p in range(P)
    ]


def solve_tabu(
    problem: MapProblem,
    n_starts: int = 8,
    n_iters: int = 400,
    tabu_tenure: int = 7,
    pool_size: int = 16,
    seed: int = 0,
    backend=None,
) -> SolveResult:
    """Multi-start steepest-descent tabu search with adaptive constraint penalty.

    ``backend`` is a string or an ``ExecutionContext``; the torch backend (the
    default, on the card) advances all starts in lockstep, scoring every
    start's single-flip neighborhood as one batched device evaluation per
    iteration (see ``_solve_tabu_torch``); ``"numpy"`` is the serial
    per-start oracle.
    """
    ctx = as_context(backend)
    if ctx.is_torch:
        return _solve_tabu_torch(
            problem, n_starts, n_iters, tabu_tenure, pool_size, seed, ctx.device
        )
    L = problem.n
    pool: list[tuple[float, bytes]] = []
    best, best_obj = None, np.inf

    for s_idx, l in enumerate(_tabu_starts(problem, n_starts, seed)):
        l = l.copy()
        rho = 1.0
        tabu = np.zeros(L, dtype=np.int64)
        cur_pen = problem.obj.value(l) + rho * problem.violation(l)
        for it in range(n_iters):
            d_obj = problem.obj.flip_deltas(l)
            # violation deltas require candidate evaluation; vectorize: build all
            # single-flip neighbors lazily through expression deltas.
            d_b = problem.behav.flip_deltas(l)
            d_p = problem.ppa.flip_deltas(l)
            vb = problem.behav.value(l)
            vp = problem.ppa.value(l)
            nb = np.maximum(0.0, vb + d_b - problem.max_behav) / max(abs(problem.max_behav), 1e-9)
            np_ = np.maximum(0.0, vp + d_p - problem.max_ppa) / max(abs(problem.max_ppa), 1e-9)
            cand_pen = problem.obj.value(l) + d_obj + rho * (nb + np_)
            blocked = tabu > it
            # aspiration: allow tabu move if it beats the global best and is feasible
            asp = (cand_pen < best_obj) & (nb + np_ <= 0)
            score = np.where(blocked & ~asp, np.inf, cand_pen)
            k = int(np.argmin(score))
            if not np.isfinite(score[k]):
                break
            move_gain = cur_pen - score[k]
            l[k] = 1.0 - l[k]
            tabu[k] = it + tabu_tenure
            cur_pen = score[k]
            if problem.violation(l[None])[0] <= 0:
                obj = float(problem.obj.value(l))
                key = l.astype(np.uint8).tobytes()
                pool.append((obj, key))
                if obj < best_obj:
                    best_obj, best = obj, l.astype(np.uint8).copy()
            else:
                rho *= 1.05  # infeasible: tighten the penalty
            if move_gain <= 1e-12 and it > 20 and rho > 100:
                break

    return _tabu_pool_result(pool, best, best_obj, pool_size, L)


def solve_bnb(
    problem: MapProblem,
    node_budget: int = 200_000,
    pool_size: int = 16,
) -> SolveResult:
    """Depth-first branch-and-bound; exact within budget, anytime beyond it."""
    L = problem.n
    # Branch variables in order of |objective influence| (largest first).
    sym = problem.obj.quad + problem.obj.quad.T
    influence = np.abs(problem.obj.lin) + np.abs(sym).sum(axis=1)
    order = np.argsort(-influence)

    best, best_obj = None, np.inf
    pool: list[tuple[float, bytes]] = []
    fixed_mask = np.zeros(L, dtype=bool)
    fixed_val = np.zeros(L, dtype=np.float64)
    nodes = 0

    def behav_lb(mask, val):
        return problem.behav.lower_bound_free(mask, val)

    def ppa_lb(mask, val):
        return problem.ppa.lower_bound_free(mask, val)

    def rec(depth: int):
        nonlocal nodes, best, best_obj
        nodes += 1
        if nodes > node_budget:
            return
        lb = problem.obj.lower_bound_free(fixed_mask, fixed_val)
        if lb >= best_obj - 1e-12:
            return
        if behav_lb(fixed_mask, fixed_val) > problem.max_behav + 1e-9:
            return
        if ppa_lb(fixed_mask, fixed_val) > problem.max_ppa + 1e-9:
            return
        if depth == L:
            l = fixed_val.copy()
            if problem.violation(l[None])[0] <= 0:
                obj = float(problem.obj.value(l))
                pool.append((obj, l.astype(np.uint8).tobytes()))
                if obj < best_obj:
                    best_obj, best = obj, l.astype(np.uint8).copy()
            return
        k = order[depth]
        fixed_mask[k] = True
        # Greedy child order: try the sign-suggested value first.
        sym_k = sym[k]
        first = 0.0 if (problem.obj.lin[k] + sym_k @ fixed_val) > 0 else 1.0
        for v in (first, 1.0 - first):
            fixed_val[k] = v
            rec(depth + 1)
        fixed_mask[k] = False
        fixed_val[k] = 0.0

    rec(0)
    if best is None:
        return SolveResult(None, np.inf, np.empty((0, L), dtype=np.uint8), "bnb")
    seen = {}
    for obj, key in sorted(pool):
        if key not in seen:
            seen[key] = obj
        if len(seen) >= pool_size:
            break
    pool_arr = np.stack([np.frombuffer(k, dtype=np.uint8) for k in seen])
    return SolveResult(best, best_obj, pool_arr, "bnb")


def solve(
    problem: MapProblem, seed: int = 0, pool_size: int = 16, backend=None
) -> SolveResult:
    """Dispatch: exact enumeration when tractable, tabu otherwise (default: the card)."""
    if problem.n <= 16:
        return solve_enumerate(problem, pool_size=pool_size, backend=backend)
    return solve_tabu(problem, seed=seed, pool_size=pool_size, backend=backend)


def solve_pool(
    problems: list[MapProblem],
    seed: int = 0,
    pool_size: int = 8,
    backend=None,
) -> np.ndarray:
    """Union of solution pools over a problem list (dedup) -- the MaP config pool.

    Under a torch ``backend``/context (the default, on the card) on tabu-sized instances (L > 16) the
    whole battery is solved by :func:`solve_tabu_multi`: one lockstep
    (problems x starts, L) batch, one neighborhood evaluation per iteration
    for ALL problems, instead of re-entering the solver once per problem.
    """
    ctx = as_context(backend)
    tel = ctx.tel
    same_l_tabu = (
        bool(problems)
        and problems[0].n > 16
        and all(p.n == problems[0].n for p in problems)
    )
    with tel.span("miqcp.solve_pool", n_problems=len(problems),
                  lockstep=bool(ctx.is_torch and same_l_tabu)):
        if ctx.is_torch and same_l_tabu:
            tel.count("dispatch.miqcp.tabu_multi")
            results = solve_tabu_multi(
                problems,
                seeds=[seed + k for k in range(len(problems))],
                pool_size=pool_size,
                backend=ctx,
            )
        else:
            tel.count("dispatch.miqcp.solve", len(problems))
            results = [
                solve(prob, seed=seed + k, pool_size=pool_size, backend=ctx)
                for k, prob in enumerate(problems)
            ]
    configs = [res.pool for res in results if len(res.pool)]
    if not configs:
        return np.empty((0, problems[0].n if problems else 0), dtype=np.uint8)
    allc = np.concatenate(configs)
    _, idx = np.unique(allc, axis=0, return_index=True)
    return allc[np.sort(idx)]
