"""Constraint-dominance counts and fronts, kernel K3, beside their plain versions.

``dominance_counts`` replaces ``repro/kernels/moo_kernels.py::
dominance_counts_pallas``; the CUDA source is ``csrc/moo_kernels.cu``, whose
header says what bounds it on the H100.  For every point it returns the
number of *active* points that constraint-dominate it (``moo.
fast_nondominated_sort``'s rule): j dominates i iff both are feasible
(``viol <= 0``) and j Pareto-dominates i, or j is feasible and i is not, or
both are infeasible and ``viol_j < viol_i``.

The plain version is the column sums of :func:`dominance_matrix` over the
active rows.  On a CPU tensor the wrapper returns it; on a CUDA tensor it
launches the kernel or raises.  ``dominance_counts.launches`` counts kernel
launches.  Any P is accepted (the kernel masks its ragged last tile); rows
padded with inactive +inf-violation points are never counted.

``constraint_fronts`` peels every feasible front in one launch of the same
source: it returns each feasible point's front (0 = best; -1 for an
infeasible point) and the number of feasible fronts as a device scalar, so a
ranking built on it needs no host sync.  Its plain version is the round loop
:func:`peel_fronts` over ``dominance_counts_plain``.  The kernel is one block
of one thread per point, so it takes P <= ``FRONTS_MAX_P``; above that the
wrapper peels round by round with ``dominance_counts`` instead (a route by
size between two kernels, one launch and one host sync a front).
``constraint_fronts.launches`` counts its kernel's launches.

``constraint_fronts_lanes`` is the front peel over L lanes of a batched GA
(the lane axis of ``CompiledNSGA2.run_sweep``): objs (L, P, n_obj), viol
(L, P) -> fronts (L, P) and counts (L,), one launch of the same kernel with a
block a lane.  Its plain version is ``constraint_fronts_plain`` lane by lane.
It has no round-by-round route: P above ``FRONTS_MAX_P`` raises.
``constraint_fronts_lanes.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["dominance_matrix", "dominance_counts_plain", "dominance_counts", "peel_fronts",
           "constraint_fronts_plain", "constraint_fronts", "constraint_fronts_lanes_plain",
           "constraint_fronts_lanes", "FRONTS_MAX_P"]

MAX_OBJ = 4  # objective registers per thread in the kernel
FRONTS_MAX_P = 1024  # constraint_fronts: one block, one thread per point


def dominance_matrix(objs: torch.Tensor, viol: torch.Tensor) -> torch.Tensor:
    """(n, n) bool, ``[i, j]`` = i constraint-dominates j."""
    le = (objs[:, None, :] <= objs[None, :, :]).all(-1)
    lt = (objs[:, None, :] < objs[None, :, :]).any(-1)
    fi = viol <= 0
    dom = (fi[:, None] & fi[None, :]) & (le & lt)
    dom |= fi[:, None] & ~fi[None, :]
    dom |= (~fi[:, None] & ~fi[None, :]) & (viol[:, None] < viol[None, :])
    return dom


def dominance_counts_plain(objs: torch.Tensor, viol: torch.Tensor,
                           active: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: (P,) int32 counts of active dominators."""
    return (dominance_matrix(objs, viol) & active[:, None]).sum(0, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("moo_kernels")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dominance_counts_launch.argtypes = [p, p, p, p, i, i, p]
    lib.dominance_counts_launch.restype = ctypes.c_int
    lib.constraint_fronts_launch.argtypes = [p, p, p, p, i, i, p]
    lib.constraint_fronts_launch.restype = ctypes.c_int
    lib.constraint_fronts_lanes_launch.argtypes = [p, p, p, p, i, i, i, p]
    lib.constraint_fronts_lanes_launch.restype = ctypes.c_int
    return lib


def _check(objs: torch.Tensor, *others) -> None:
    """objs (P, n_obj) f32 and each ``(tensor, name, dtype)`` of shape (P,),
    all contiguous on objs' device."""
    if objs.dim() != 2:
        raise ValueError(f"objs must be (P, n_obj), got {tuple(objs.shape)}")
    p, n_obj = objs.shape
    for t, name, dtype, shape in ((objs, "objs", torch.float32, (p, n_obj)),) + tuple(
            (t, name, dtype, (p,)) for t, name, dtype in others):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name} must be {dtype} of shape {shape}, got {t.dtype} {tuple(t.shape)}"
            )
        if t.device != objs.device:
            raise ValueError(f"{name} is on {t.device}, expected {objs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if objs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {objs.device}")
    if objs.device.type == "cuda" and not 1 <= n_obj <= MAX_OBJ:
        raise ValueError(f"the kernel takes 1..{MAX_OBJ} objectives, got {n_obj}")


def dominance_counts(objs: torch.Tensor, viol: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """K3: objs (P, n_obj) f32, viol (P,) f32, active (P,) bool -> (P,) int32."""
    _check(objs, (viol, "viol", torch.float32), (active, "active", torch.bool))
    if objs.device.type == "cpu":
        return dominance_counts_plain(objs, viol, active)
    p, n_obj = objs.shape
    out = torch.empty(p, dtype=torch.int32, device=objs.device)
    if p == 0:
        return out
    stream = torch.cuda.current_stream(objs.device).cuda_stream
    err = _lib().dominance_counts_launch(
        objs.data_ptr(), viol.data_ptr(), active.data_ptr(), out.data_ptr(),
        p, n_obj, stream,
    )
    if err != 0:
        raise RuntimeError(f"dominance_counts launch failed: cudaError {err}")
    dominance_counts.launches += 1
    return out


dominance_counts.launches = 0


def peel_fronts(count_fn, feas: torch.Tensor):
    """Feasible fronts peeled one round at a time: each round the feasible
    points with no dominator among the feasible points still unplaced (by
    ``count_fn(active) -> (P,) counts``) form the next front.  Returns
    (front (P,) int64, -1 for infeasible points; number of fronts, a 0-d
    int64 tensor).  One ``.any()`` host sync a round."""
    n = feas.shape[0]
    front = torch.full((n,), -1, dtype=torch.int64, device=feas.device)
    assigned = ~feas  # infeasible points never block a feasible one
    r = 0
    while r <= n and bool((~assigned).any()):
        counts = count_fn(~assigned)
        joins = (counts == 0) & ~assigned
        front = torch.where(joins, r, front)
        assigned = assigned | joins
        r += 1
    return front, torch.tensor(r, dtype=torch.int64, device=feas.device)


def constraint_fronts_plain(objs: torch.Tensor, viol: torch.Tensor):
    """Plain version of ``constraint_fronts``: the round loop over
    ``dominance_counts_plain``."""
    return peel_fronts(lambda active: dominance_counts_plain(objs, viol, active), viol <= 0)


def constraint_fronts(objs: torch.Tensor, viol: torch.Tensor):
    """K3's front peel: objs (P, n_obj) f32, viol (P,) f32 -> (front (P,)
    int64, -1 where infeasible; number of feasible fronts, 0-d int64), both
    on objs' device.  One launch for P <= FRONTS_MAX_P; above, one
    ``dominance_counts`` launch and one host sync a front."""
    _check(objs, (viol, "viol", torch.float32))
    if objs.device.type == "cpu":
        return constraint_fronts_plain(objs, viol)
    p, n_obj = objs.shape
    if p > FRONTS_MAX_P:
        return peel_fronts(lambda active: dominance_counts(objs, viol, active), viol <= 0)
    front = torch.empty(p, dtype=torch.int64, device=objs.device)
    if p == 0:
        return front, torch.zeros((), dtype=torch.int64, device=objs.device)
    n_fronts = torch.empty((), dtype=torch.int64, device=objs.device)   # the kernel writes it
    stream = torch.cuda.current_stream(objs.device).cuda_stream
    err = _lib().constraint_fronts_launch(
        objs.data_ptr(), viol.data_ptr(), front.data_ptr(), n_fronts.data_ptr(),
        p, n_obj, stream,
    )
    if err != 0:
        raise RuntimeError(f"constraint_fronts launch failed: cudaError {err}")
    constraint_fronts.launches += 1
    return front, n_fronts


constraint_fronts.launches = 0


def constraint_fronts_lanes_plain(objs: torch.Tensor, viol: torch.Tensor):
    """Plain version of ``constraint_fronts_lanes``: ``constraint_fronts_plain``
    lane by lane."""
    fronts, counts = [], []
    for o, v in zip(objs, viol):
        f, n = constraint_fronts_plain(o, v)
        fronts.append(f)
        counts.append(n)
    return torch.stack(fronts), torch.stack(counts)


def constraint_fronts_lanes(objs: torch.Tensor, viol: torch.Tensor):
    """K3's front peel over lanes: objs (L, P, n_obj) f32, viol (L, P) f32 ->
    (front (L, P) int64, -1 where infeasible; feasible fronts a lane (L,)
    int64), on objs' device.  One launch for every lane; P <= FRONTS_MAX_P."""
    if objs.dim() != 3 or viol.dim() != 2 or tuple(viol.shape) != tuple(objs.shape[:2]):
        raise ValueError(f"objs must be (L, P, n_obj) and viol (L, P), got "
                         f"{tuple(objs.shape)} and {tuple(viol.shape)}")
    lanes, p, n_obj = objs.shape
    if not (objs.is_contiguous() and viol.is_contiguous()):
        raise ValueError("objs and viol must be contiguous")
    # each lane's operands as constraint_fronts checks them
    _check(objs.reshape(lanes * p, n_obj), (viol.reshape(-1), "viol", torch.float32))
    if objs.device.type == "cpu":
        return constraint_fronts_lanes_plain(objs, viol)
    if p > FRONTS_MAX_P:
        raise ValueError(f"constraint_fronts_lanes takes P <= {FRONTS_MAX_P} points a "
                         f"lane, got {p}")
    front = torch.empty((lanes, p), dtype=torch.int64, device=objs.device)
    n_fronts = torch.zeros(lanes, dtype=torch.int64, device=objs.device)
    if lanes * p == 0:
        return front, n_fronts
    stream = torch.cuda.current_stream(objs.device).cuda_stream
    err = _lib().constraint_fronts_lanes_launch(
        objs.data_ptr(), viol.data_ptr(), front.data_ptr(), n_fronts.data_ptr(),
        lanes, p, n_obj, stream,
    )
    if err != 0:
        raise RuntimeError(f"constraint_fronts_lanes launch failed: cudaError {err}")
    constraint_fronts_lanes.launches += 1
    return front, n_fronts


constraint_fronts_lanes.launches = 0
