"""Device NSGA-II engine (the GA's ``backend="torch"`` path).

Counterpart of ``repro/core/fastmoo.py``.  The whole search runs on the
context's device as a per-generation loop of tensor operations:

  * seeded initialization from a device ``torch.Generator`` (rows of a MaP
    pool replace the first random rows),
  * constraint-dominated ranks: kernel K3 (``kernels.moo_kernels.
    constraint_fronts``) peels every feasible front in one launch and leaves
    the fronts' count on the device, and infeasible points take the closed
    form ``n_feasible_fronts + dense_rank(violation)``: no host sync,
  * crowding distance over all fronts at once (rank-segmented sort plus
    segment min/max spans),
  * binary tournament selection, single-point crossover, bit-flip mutation,
  * rank-then-crowding environmental selection on the combined population,
  * a preallocated device archive of every evaluated individual, whose
    feasible subset's exact 2-D hypervolume is computed at the numpy oracle's
    checkpoints.

``CompiledNSGA2.run_sweep`` runs L lanes of one GA (a seed x constraint-bound
grid) in one batched program, and ``run`` is its one-lane case: each lane
draws from its own generator and is evaluated at one lane's shape, so a lane
reproduces ``run`` at its seed, bounds and seed pool; the ranking is one
launch of K3 over all lanes (``constraint_fronts_lanes``; a single lane
launches ``constraint_fronts``), and crowding, tournament, crossover,
mutation and environmental selection are batched over lanes.

The numpy ``moo.nsga2`` stays the behavioral oracle: identical operators and
selection semantics, but torch's random streams differ from numpy's, so the
contract is *hypervolume parity* (feasible-archive hypervolume within 2%),
not bit parity.

With ``telemetry="on"`` (a sink whose ``device_taps`` is set) and an
``hv_ref``, ``run`` is tapped: every generation merges its children into a
nondominated-front buffer (:func:`front_update`, capacity
``front_capacity``) and writes one row ``(gen, hv, arc_feasible,
pop_viol_mean, pop_feas, front)`` into a chunk buffer on the device, which a
batched device tap (``obs.device``) stages to the host at every chunk
boundary without a sync; ``run`` drains the ``fastmoo.gen`` series at its
end.  The checkpoint ``hv_history`` stays archive-based in both programs, so
it is bit-identical tapped and untapped.  Sweeps stay untapped, as in the
reference (lanes would interleave into one series).  ``run`` counts
``dispatch.fastmoo.run`` and ``run_sweep`` ``dispatch.fastmoo.sweep``, each
in a span of the same name.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from ..kernels import registry
from ..kernels.moo_kernels import (
    constraint_fronts,
    constraint_fronts_lanes,
    dominance_matrix,
    peel_fronts,
)
from ..obs import device as obs_device
from .engine import ENGINE_MENUS, ExecutionContext, shard_plan
from .moo import GAResult

__all__ = [
    "UNBOUNDED",
    "RANK_IMPLS",
    "dominance_matrix",
    "constraint_ranks",
    "constraint_ranks_lanes",
    "crowding_distance",
    "crowding_distance_lanes",
    "hypervolume_2d",
    "front_update",
    "front_hypervolume",
    "CompiledNSGA2",
    "nsga2_torch",
]

# Effectively-unconstrained bound: max(0, y - 1e30) == 0 for any real metric,
# and 1e30 stays finite in f32 so the normalized violation is an exact 0.
UNBOUNDED = 1e30

# "kernel": K3 peels every front in one launch; "plain": the (n, n)
# dominance matrix is built once and counted by masked column sums each round.
RANK_IMPLS = ENGINE_MENUS["fastmoo"]

# hv_history checkpoints: every 10th generation and the last, as moo.nsga2.
RECORD_EVERY = 10

# the tapped GA's chunk: a (TAP_CHUNK, 6) row buffer on the device, staged to
# the host by one batched tap a chunk
TAP_CHUNK = 32
TAP_FIELDS = ("gen", "hv", "arc_feasible", "pop_viol_mean", "pop_feas", "front")


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort`` for 1-D tensors: the LAST key is the primary one."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def constraint_ranks(objs: torch.Tensor, viol: torch.Tensor,
                     impl: str = "kernel") -> torch.Tensor:
    """(n,) int64 fronts (0 = best) under constraint domination; torch twin
    of ``moo.fast_nondominated_sort``.

    Only feasible points are peeled into fronts (a point joins the next front
    when no feasible point still unplaced dominates it, identical to the
    oracle's incremental subtraction).  Infeasible points are totally
    ordered by violation and dominated by every feasible point, so their
    ranks are ``n_feasible_fronts + dense_rank(violation)``, computed from
    the fronts' count on the device.  ``impl="kernel"`` peels with K3's
    ``constraint_fronts``: on the card one launch and no host sync for the
    whole ranking (above ``FRONTS_MAX_P`` points one launch and one sync a
    front).  ``impl="plain"`` builds the dominance matrix once and peels
    round by round, one host sync a front.
    """
    objs = objs.to(torch.float32).contiguous()
    viol = viol.to(torch.float32).contiguous()
    if impl == "kernel":
        front, n_fronts = constraint_fronts(objs, viol)
    elif impl == "plain":
        dom = dominance_matrix(objs, viol)
        front, n_fronts = peel_fronts(
            lambda active: (dom & active[:, None]).sum(0, dtype=torch.int32), viol <= 0)
    else:
        raise ValueError(f"unknown rank impl {impl!r} (menu: {RANK_IMPLS})")
    return _dense_infeasible(front, n_fronts, viol, dim=0)


def _dense_infeasible(front, n_fronts, viol, dim: int):
    """Ranks along ``dim``: feasible points keep their front, infeasible ones
    take ``n_fronts + dense_rank(violation)`` (``n_fronts`` broadcasting
    against the other dims)."""
    feas = viol <= 0
    vio = torch.where(feas, float("-inf"), viol)
    order = torch.argsort(vio, dim=dim, stable=True)
    vs = vio.gather(dim, order)
    first = torch.full_like(vs.narrow(dim, 0, 1), float("-inf"))
    prev = torch.cat([first, vs.narrow(dim, 0, vs.shape[dim] - 1)], dim=dim)
    dense = torch.cumsum((vs > prev).to(torch.int64), dim=dim)  # 1-based distinct id
    ranked = torch.where(feas.gather(dim, order), front.gather(dim, order),
                         n_fronts + dense - 1)
    return torch.empty_like(front).scatter_(dim, order, ranked)


def constraint_ranks_lanes(objs: torch.Tensor, viol: torch.Tensor,
                           impl: str = "kernel") -> torch.Tensor:
    """(L, P) int64 ranks of L independent lanes, each equal to
    :func:`constraint_ranks` on its lane.  ``impl="kernel"`` peels every
    lane's fronts in one launch of K3 (``constraint_fronts_lanes``), with no
    host sync; one lane (``run``) is ranked by :func:`constraint_ranks`, so
    it launches ``constraint_fronts`` (counted there) and keeps its route
    above ``FRONTS_MAX_P``.  ``impl="plain"`` ranks lane by lane on the
    plain versions."""
    objs = objs.to(torch.float32).contiguous()
    viol = viol.to(torch.float32).contiguous()
    if impl == "plain" or objs.shape[0] == 1:
        return torch.stack([constraint_ranks(o, v, impl=impl) for o, v in zip(objs, viol)])
    if impl != "kernel":
        raise ValueError(f"unknown rank impl {impl!r} (menu: {RANK_IMPLS})")
    front, n_fronts = constraint_fronts_lanes(objs, viol)
    return _dense_infeasible(front, n_fronts[:, None], viol, dim=1)


def crowding_distance_lanes(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """(L, P, m) objectives, (L, P) ranks -> (L, P) crowding distances, each
    lane equal to :func:`crowding_distance` on it: the lanes' fronts are made
    distinct segments of one flat pass (rank + P * lane; ranks are below P)."""
    lanes, p, m = objs.shape
    key = rank + p * torch.arange(lanes, device=rank.device)[:, None]
    return crowding_distance(objs.reshape(lanes * p, m), key.reshape(-1)).reshape(lanes, p)


def crowding_distance(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Per-front crowding distance for all fronts in one pass.

    Equivalent to ``moo.crowding_distance`` on each front: a stable (rank,
    objective) sort makes front members contiguous, so segment boundaries are
    the per-front extremes (inf) and interior members take span-normalized
    neighbor gaps.  Fronts of <= 2 members are all-boundary.
    """
    n, m = objs.shape
    dist = torch.zeros(n, dtype=torch.float32, device=objs.device)
    if n == 0:
        return dist
    for k in range(m):
        o = objs[:, k].to(torch.float32)
        seg_max = torch.full((n,), float("-inf"), device=o.device).scatter_reduce(
            0, rank, o, reduce="amax")
        seg_min = torch.full((n,), float("inf"), device=o.device).scatter_reduce(
            0, rank, o, reduce="amin")
        span = seg_max - seg_min
        order = _lexsort((o, rank))
        ro = rank[order]
        oo = o[order]
        brk = ro[1:] != ro[:-1]
        one = torch.ones(1, dtype=torch.bool, device=o.device)
        first = torch.cat([one, brk])
        last = torch.cat([brk, one])
        prev = torch.cat([oo[:1], oo[:-1]])
        nxt = torch.cat([oo[1:], oo[-1:]])
        sp = span[ro]
        gap = torch.where(sp > 0, (nxt - prev) / torch.where(sp > 0, sp, 1.0), 0.0)
        dist[order] += torch.where(first | last, float("inf"), gap)
    return dist


def hypervolume_2d(objs: torch.Tensor, valid: torch.Tensor,
                   ref: torch.Tensor) -> torch.Tensor:
    """Exact 2-D hypervolume (f32) of the valid subset w.r.t. ``ref`` (minimized).

    Invalid and beyond-reference points sort to +inf and contribute nothing;
    an x sort plus an exclusive running y-minimum reproduces the oracle's
    Pareto staircase sweep without a Pareto filter.
    """
    valid = valid & (objs[:, 0] <= ref[0]) & (objs[:, 1] <= ref[1])
    x = torch.where(valid, objs[:, 0], float("inf"))
    y = torch.where(valid, objs[:, 1], float("inf"))
    # for tied x the staircase contributions telescope to the same total
    # whatever the y order, so one sort key is enough
    order = torch.argsort(x, stable=True)
    xs, ys = x[order], y[order]
    run = torch.minimum(torch.cummin(ys, dim=0).values, ref[1])
    prev = torch.cat([ref[1:2], run[:-1]])
    contrib = (ref[0] - xs) * (prev - ys)
    return torch.where(torch.isfinite(xs) & (ys < prev), contrib, 0.0).sum()


def front_update(buf_x, buf_y, objs, viol, ref):
    """Merge candidate points into a sorted nondominated-front buffer.

    ``buf_x``/``buf_y`` are ``(F,)`` f32 holding the current staircase (x
    ascending, y strictly descending), +inf-padded.  Feasible within-reference
    candidates are merged and the strict staircase re-extracted; if the front
    outgrows F, the largest-x tail is dropped.
    """
    feas = (viol <= 0) & (objs[:, 0] <= ref[0]) & (objs[:, 1] <= ref[1])
    xs = torch.cat([buf_x, torch.where(feas, objs[:, 0], float("inf"))])
    ys = torch.cat([buf_y, torch.where(feas, objs[:, 1], float("inf"))])
    order = _lexsort((ys, xs))
    xs, ys = xs[order], ys[order]
    run = torch.cummin(ys, dim=0).values
    prev = torch.cat([ys.new_full((1,), float("inf")), run[:-1]])
    keep = torch.isfinite(xs) & (ys < prev)
    xs = torch.where(keep, xs, float("inf"))
    ys = torch.where(keep, ys, float("inf"))
    compact = torch.argsort(xs, stable=True)  # kept points stay x-sorted
    f = buf_x.shape[0]
    return xs[compact][:f], ys[compact][:f]


def front_hypervolume(buf_x, buf_y, ref):
    """Exact 2-D hypervolume of a :func:`front_update` buffer (one O(F) sweep),
    in f64, rounded once to f32.  The staircase's rectangles change as the
    front grows, and an f32 sum of them can fall by an ulp where the area
    rose; the rounded f64 area rises with the front."""
    x, y, r = buf_x.double(), buf_y.double(), ref.double()
    run = torch.minimum(torch.cummin(y, dim=0).values, r[1])
    prev = torch.cat([r[1:2], run[:-1]])
    contrib = (r[0] - x) * (prev - y)
    return torch.where(torch.isfinite(x) & (y < prev), contrib, 0.0).sum().float()


class CompiledNSGA2:
    """One NSGA-II run on ``ctx.device`` (name kept from the reference engine).

    ``objs_fn`` maps a ``(B, L)`` f32 tensor to ``(B, 2)`` f32 objectives on
    the same device -- e.g. ``fastchar.surrogate_objs_device``.  Constraint
    bounds ``(max_behav, max_ppa)`` give the normalized-overflow violation.
    """

    def __init__(
        self,
        objs_fn: Callable[[torch.Tensor], torch.Tensor],
        n_bits: int,
        pop_size: int = 64,
        n_gen: int = 250,
        crossover_p: float = 0.9,
        mutation_p: float | None = None,
        hv_ref: np.ndarray | None = None,
        rank_impl: str | None = None,
        ctx: ExecutionContext | None = None,
    ) -> None:
        if pop_size % 2:
            raise ValueError(f"pop_size must be even, got {pop_size}")
        ctx = ctx if ctx is not None else ExecutionContext()
        if rank_impl is None:
            rank_impl = ctx.resolve_impl("fastmoo", "kernel")
        if rank_impl not in RANK_IMPLS:
            raise ValueError(f"unknown rank_impl {rank_impl!r}")
        self.n_bits = int(n_bits)
        self.pop_size = int(pop_size)
        self.n_gen = int(n_gen)
        self.crossover_p = float(crossover_p)
        self.mutation_p = float(mutation_p if mutation_p is not None else 1.0 / n_bits)
        self.hv_ref = None if hv_ref is None else np.asarray(hv_ref, np.float64)
        self.rank_impl = rank_impl
        self.device = torch.device(ctx.device)
        self._objs_fn = objs_fn
        # the nondominated-front buffer of the tapped per-generation hv (4P is
        # generous for a 2-objective staircase; the tap's "front" field shows
        # saturation)
        self.front_capacity = 4 * self.pop_size
        self._ctx = ctx
        self._tel = ctx.tel
        self._tapped = self.hv_ref is not None and self._tel.device_taps

    def _prep_init(self, initial_population) -> tuple[np.ndarray, int]:
        """Seed rows for the initial population.

        Accepts one (k, n_bits) array or a list/tuple of pools: pools
        concatenate in order and truncate to ``pop_size``; an empty/None pool
        contributes nothing.
        """
        if isinstance(initial_population, (list, tuple)):
            parts = [np.asarray(p, np.uint8) for p in initial_population
                     if p is not None and len(p)]
            initial_population = np.concatenate(parts) if parts else None
        init = np.zeros((self.pop_size, self.n_bits), np.uint8)
        k = 0
        if initial_population is not None and len(initial_population):
            k = min(len(initial_population), self.pop_size)
            init[:k] = np.asarray(initial_population)[:k]
        return init, k

    def _evaluator(self, max_behav: float, max_ppa: float):
        """``pop (B, L) -> (objs (B, 2), viol (B,))`` at one lane's bounds."""
        max_b = float(np.float32(max_behav))
        max_p = float(np.float32(max_ppa))
        den_b = float(np.float32(max(abs(max_behav), 1e-9)))
        den_p = float(np.float32(max(abs(max_ppa), 1e-9)))

        def evaluate(pop):
            objs = self._objs_fn(pop.to(torch.float32))
            vb = (objs[:, 0] - max_b).clamp(min=0.0) / den_b
            vp = (objs[:, 1] - max_p).clamp(min=0.0) / den_p
            return objs, vb + vp

        return evaluate

    def run(
        self,
        seed: int = 0,
        max_behav: float = UNBOUNDED,
        max_ppa: float = UNBOUNDED,
        initial_population: np.ndarray | None = None,
    ) -> GAResult:
        """One full GA run on the device; returns host arrays.  The one-lane
        case of :meth:`run_sweep`, tapped where the context asks for taps."""
        tel = self._tel
        tel.count("dispatch.fastmoo.run")
        with tel.span("fastmoo.run", pop=self.pop_size, n_gen=self.n_gen, seed=seed):
            st = self._setup([seed], [(max_behav, max_ppa)], [initial_population],
                             tapped=self._tapped)
            self._generations(st)
            out = self._results(st)[0]
            if self._tapped:
                obs_device.flush()   # drain the staged rows into the series
        return out

    def run_sweep(self, seeds, bounds, initial_populations=None) -> list[GAResult]:
        """A (seed x constraint-bound) sweep as one batched GA; lane i equals
        ``run(seeds[i], *bounds[i], initial_populations[i])``.

        ``bounds``: (S, 2) [max_behav, max_ppa] rows; ``initial_populations``:
        optional per-lane seed pools (entries may be None, empty or a tuple of
        pools).  Each lane draws from its own generator (torch's draws depend
        on their shape, so lanes cannot share one), and the surrogate is
        evaluated lane by lane at one lane's shape (a batched product may sum
        in another order and move a near-tie); the ranking is one launch of
        K3 over all lanes (:func:`constraint_ranks_lanes`), and crowding,
        tournament, crossover, mutation and environmental selection run
        batched over the lanes.  Sweeps are untapped.  A context that shards
        ``"lanes"`` splits the lanes over its devices
        (:meth:`_sharded_sweep`); each lane's result is the same.
        """
        seeds = [int(x) for x in seeds]
        if not seeds:
            return []
        tel = self._tel
        tel.count("dispatch.fastmoo.sweep")
        with tel.span("fastmoo.sweep", n_lanes=len(seeds), pop=self.pop_size,
                      n_gen=self.n_gen):
            if self._ctx.shards("lanes"):
                return self._sharded_sweep(seeds, bounds, initial_populations)
            st = self._setup(seeds, bounds, initial_populations, tapped=False)
            self._generations(st)
            return self._results(st)

    def _on_device(self, ctx: ExecutionContext) -> "CompiledNSGA2":
        """This runner on a shard's device: the same settings, its objectives
        evaluated there (``objs_fn.on(device)`` where the device differs)."""
        runner = copy.copy(self)
        runner.device, runner._ctx = torch.device(ctx.device), ctx
        if runner.device != self.device:
            on = getattr(self._objs_fn, "on", None)
            if on is None:
                raise ValueError(f"a lane shard on {ctx.device} needs objs_fn.on(device) "
                                 f"(the objectives are bound to {self.device}); "
                                 "fastchar.surrogate_objs_device provides it")
            runner._objs_fn = on(ctx.device)
        return runner

    def _sharded_sweep(self, seeds, bounds, initial_populations) -> list[GAResult]:
        """The sweep's lanes split over the context's shards (the reference's
        ``shard_map`` over lanes).  The lane count is padded to a multiple of
        the shard count by repeating lane 0; each shard runs its contiguous
        lanes as one batched GA on its device (K3's lanes instance ranking
        them), the shards' generations interleaved so that their launches
        overlap on their cards; the padding lanes are dropped on the host.
        Lanes never interact, so every lane equals the unsharded sweep's."""
        n, S = self._ctx.device_count, len(seeds)
        pad = (-S) % n
        bounds = np.asarray(bounds, np.float64).reshape(S, 2)
        pools = [None] * S if initial_populations is None else list(initial_populations)
        seeds, pools = seeds + seeds[:1] * pad, pools + pools[:1] * pad
        bounds = np.concatenate([bounds, np.repeat(bounds[:1], pad, axis=0)])
        bucket = registry.get(f"fastmoo.{self.rank_impl}").bucket(p=self.pop_size)
        runners = [self._on_device(sc)
                   for sc in shard_plan(self._ctx, "fastmoo", self.rank_impl, bucket)]
        per = len(seeds) // n
        part = lambda x, i: x[i * per:(i + 1) * per]
        states = [r._setup(part(seeds, i), part(bounds, i), part(pools, i), tapped=False)
                  for i, r in enumerate(runners)]
        for g in range(self.n_gen):
            for r, st in zip(runners, states):
                r._generation(st, g)
        return [res for r, st in zip(runners, states) for res in r._results(st)][:S]

    def _setup(self, seeds, bounds, initial_populations, tapped: bool) -> dict:
        """The state of a batched run before its first generation: the lanes'
        generators and evaluators, the initial populations (host seed pools
        copied to the device) and their objectives, the archive, and, tapped,
        the front buffer and the chunk's row buffer and tap."""
        S = len(seeds)
        bounds = np.asarray(bounds, np.float64).reshape(S, 2)
        P, L, G = self.pop_size, self.n_bits, self.n_gen
        dev = self.device
        st = {"S": S, "gens": [torch.Generator(device=dev).manual_seed(x) for x in seeds],
              "evals": [self._evaluator(b, p) for b, p in bounds],
              "lane": torch.arange(S, device=dev), "cols": torch.arange(L, device=dev)}
        ref = st["ref"] = (None if self.hv_ref is None
                           else torch.as_tensor(self.hv_ref, dtype=torch.float32, device=dev))
        pop = torch.stack([torch.randint(0, 2, (P, L), generator=g, device=dev,
                                         dtype=torch.uint8) for g in st["gens"]])
        for i in range(S):
            pool = None if initial_populations is None else initial_populations[i]
            init, k = self._prep_init(pool)
            if k:
                pop[i, :k] = torch.from_numpy(init[:k]).to(dev)
        objs, viol = self._evaluate(st, pop)

        M = P * (G + 1)
        arc_c = torch.zeros((S, M, L), dtype=torch.uint8, device=dev)
        arc_o = torch.full((S, M, 2), float("inf"), dtype=torch.float32, device=dev)
        arc_v = torch.full((S, M), float("inf"), dtype=torch.float32, device=dev)
        arc_c[:, :P], arc_o[:, :P], arc_v[:, :P] = pop, objs, viol
        st.update(pop=pop, objs=objs, viol=viol, arc_c=arc_c, arc_o=arc_o, arc_v=arc_v)
        st["hv_dev"] = [] if ref is None else [(P, self._hv_now(st))]
        st["tap"] = None
        if tapped and ref is not None and S == 1:
            # the front buffer starts from the initial population: the archive
            # holds it and every generation's children, which is what the
            # buffer accumulates
            inf = torch.full((self.front_capacity,), float("inf"), device=dev)
            st["front"] = front_update(inf, inf.clone(), objs[0], viol[0], ref)
            st["chunk"] = min(G, TAP_CHUNK) or 1
            st["gen_ids"] = torch.arange(G, dtype=torch.float32, device=dev)
            st["tap"] = self._tel.device_batched_tap("fastmoo.gen", TAP_FIELDS)
        return st

    def _evaluate(self, st, pops):
        pairs = [ev(x) for ev, x in zip(st["evals"], pops)]
        return torch.stack([o for o, _ in pairs]), torch.stack([v for _, v in pairs])

    @staticmethod
    def _hv_now(st):
        return [hypervolume_2d(st["arc_o"][i], st["arc_v"][i] <= 0, st["ref"])
                for i in range(st["S"])]

    def _tap_row(self, st, g: int, c_objs, c_viol) -> None:
        """Generation ``g``'s row into the chunk buffer, the buffer to the tap
        at the chunk's end; device work only, no host sync."""
        C, G = st["chunk"], self.n_gen
        if g % C == 0:
            st["rows"] = torch.full((C, len(TAP_FIELDS)), -1.0, device=self.device)
        buf_x, buf_y = st["front"] = front_update(*st["front"], c_objs[0], c_viol[0],
                                                  st["ref"])
        viol = st["viol"][0]
        st["rows"][g % C] = torch.stack([
            st["gen_ids"][g],
            front_hypervolume(buf_x, buf_y, st["ref"]),
            (st["arc_v"][0] <= 0).sum().to(torch.float32),
            viol.mean(),
            (viol <= 0).to(torch.float32).mean(),
            torch.isfinite(buf_x).sum().to(torch.float32),
        ])
        if g % C == C - 1 or g == G - 1:
            # never-written rows of a ragged last chunk keep gen == -1
            st["tap"](st["rows"], st["rows"][:, 0] >= 0.0)

    def _generations(self, st) -> None:
        """Every generation of the batched run in ``st``, in place; on the
        card no host sync a generation where the ranking is K3's."""
        for g in range(self.n_gen):
            self._generation(st, g)

    def _generation(self, st, g: int) -> None:
        """Generation ``g`` of the batched run in ``st``, in place."""
        S, P, L, G = st["S"], self.pop_size, self.n_bits, self.n_gen
        dev = self.device
        gens, ref = st["gens"], st["ref"]
        pop, objs, viol = st["pop"], st["objs"], st["viol"]
        arc_c, arc_o, arc_v = st["arc_c"], st["arc_o"], st["arc_v"]
        lane, cols = st["lane"], st["cols"]
        rank = constraint_ranks_lanes(objs, viol, impl=self.rank_impl)
        crowd = crowding_distance_lanes(objs, rank)

        draws = []
        for gen in gens:   # each lane's draws from its own generator
            cand = torch.randint(0, P, (P, 2), generator=gen, device=dev)
            do_cx = torch.rand(P // 2, generator=gen, device=dev) < self.crossover_p
            cut = torch.randint(1, L, (P // 2,), generator=gen, device=dev)
            flip = torch.rand((P, L), generator=gen, device=dev) < self.mutation_p
            draws.append((cand, do_cx, cut, flip))
        cand, do_cx, cut, flip = (torch.stack(x) for x in zip(*draws))

        # binary tournament selection
        a, b = cand[..., 0], cand[..., 1]
        ra, rb = rank.gather(1, a), rank.gather(1, b)
        better = (ra < rb) | ((ra == rb) & (crowd.gather(1, a) > crowd.gather(1, b)))
        win = torch.where(better, a, b)
        parents = pop.gather(1, win[..., None].expand(S, P, L))

        # single-point crossover on consecutive pairs
        swap = (cols[None, None, :] >= cut[..., None]) & do_cx[..., None]
        p1, p2 = parents[:, 0::2], parents[:, 1::2]
        children = torch.stack(
            [torch.where(swap, p2, p1), torch.where(swap, p1, p2)], dim=2
        ).reshape(S, P, L)

        # bit-flip mutation
        children = children ^ flip.to(torch.uint8)

        c_objs, c_viol = self._evaluate(st, children)
        lo = (g + 1) * P
        arc_c[:, lo:lo + P], arc_o[:, lo:lo + P], arc_v[:, lo:lo + P] = \
            children, c_objs, c_viol

        # environmental selection: rank, then crowding, within each lane
        all_pop = torch.cat([pop, children], 1)
        all_objs = torch.cat([objs, c_objs], 1)
        all_viol = torch.cat([viol, c_viol], 1)
        rank2 = constraint_ranks_lanes(all_objs, all_viol, impl=self.rank_impl)
        crowd2 = crowding_distance_lanes(all_objs, rank2)
        lane2 = lane[:, None].expand(S, 2 * P)
        order = _lexsort((-crowd2.reshape(-1), rank2.reshape(-1), lane2.reshape(-1)))
        sel = order.reshape(S, 2 * P)[:, :P] - 2 * P * lane[:, None]
        pop = all_pop.gather(1, sel[..., None].expand(S, P, L))
        objs = all_objs.gather(1, sel[..., None].expand(S, P, 2))
        viol = all_viol.gather(1, sel)
        st.update(pop=pop, objs=objs, viol=viol)

        if st["tap"] is not None:
            self._tap_row(st, g, c_objs, c_viol)
        if ref is not None and (g % RECORD_EVERY == RECORD_EVERY - 1 or g == G - 1):
            st["hv_dev"].append(((g + 2) * P, self._hv_now(st)))

    def _results(self, st) -> list[GAResult]:
        """The lanes' results as host arrays (one copy each, the run's sync)."""
        S = st["S"]
        host = {name: st[name].cpu().numpy()
                for name in ("pop", "objs", "arc_c", "arc_o", "arc_v")}
        hv_host = [(n, [float(h) for h in hs]) for n, hs in st["hv_dev"]]
        return [
            GAResult(
                population=host["pop"][i],
                objectives=host["objs"][i].astype(np.float64),
                archive_configs=host["arc_c"][i],
                archive_objs=host["arc_o"][i].astype(np.float64),
                archive_viol=host["arc_v"][i].astype(np.float64),
                hv_history=[(n, hs[i]) for n, hs in hv_host],
            )
            for i in range(S)
        ]


def nsga2_torch(
    objs_fn: Callable[[torch.Tensor], torch.Tensor],
    n_bits: int,
    pop_size: int = 64,
    n_gen: int = 250,
    seed: int = 0,
    initial_population: np.ndarray | None = None,
    hv_ref: np.ndarray | None = None,
    crossover_p: float = 0.9,
    mutation_p: float | None = None,
    max_behav: float = UNBOUNDED,
    max_ppa: float = UNBOUNDED,
    rank_impl: str | None = None,
    ctx: ExecutionContext | None = None,
) -> GAResult:
    """One-shot wrapper; ``moo.nsga2(backend="torch")`` lands here."""
    runner = CompiledNSGA2(
        objs_fn,
        n_bits=n_bits,
        pop_size=pop_size,
        n_gen=n_gen,
        crossover_p=crossover_p,
        mutation_p=mutation_p,
        hv_ref=hv_ref,
        rank_impl=rank_impl,
        ctx=ctx,
    )
    return runner.run(
        seed=seed,
        max_behav=max_behav,
        max_ppa=max_ppa,
        initial_population=initial_population,
    )
