"""Async batched DSE job queue: coalesce requests into sweep lane dispatches.

Counterpart of ``repro/service/queue.py``.

Clients submit :class:`DSERequest` jobs ((operator spec, app, const_sf, seed)
tuples).  A single worker thread drains the pending queue after a short linger
window, groups compatible jobs -- same operator family, app, and method -- and
dispatches each group as ONE ``run_dse_sweep`` call over the union
``const_sf x seed`` grid, so N compatible requests pay one estimator fit, one
batched GA and one characterization batch instead of N.  Lanes the
grid adds beyond what was literally requested are not wasted: their fronts
land in the operator library and serve later traffic.

Telemetry: ``service.jobs`` / ``service.batches`` / ``service.job_errors``
counters, a ``service.queue_depth`` histogram (observed at every submit) and a
``service.batch_lanes`` histogram (lanes per coalesced dispatch).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time

from .. import obs
from .store import OperatorStore


@dataclasses.dataclass(frozen=True)
class DSERequest:
    """One DSE job: which operator, which app, which constraint, which seed."""

    n_bits: int = 8
    op: str = "mul"
    signed: bool = True
    app: str | None = None
    const_sf: float = 1.0
    seed: int = 0
    method: str = "ga"

    @property
    def group(self) -> tuple:
        """Coalescing key: requests sharing it ride one sweep dispatch."""
        return (self.n_bits, self.op, self.signed, self.app, self.method)

    def spec(self):
        from ..core.operator_model import spec_for

        return spec_for(self.n_bits, op=self.op, signed=self.signed)

    @classmethod
    def from_dict(cls, d: dict) -> "DSERequest":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown request fields: {sorted(unknown)}")
        req = cls(**d)
        if req.method not in ("ga", "map+ga"):
            raise ValueError(f"unsupported method {req.method!r}")
        return req


def default_runner(settings=None, store: OperatorStore | None = None,
                   n_train: int = 200):
    """Build the queue's sweep dispatcher around :func:`run_dse_sweep`.

    Training datasets are built once per operator spec and reused across
    batches; ``store`` (shared with the endpoint) gives every dispatch the
    library's request cache, row dedup and warm starts.  ``settings``
    defaults to a small budget on the card; the dispatcher runs in the
    queue's worker thread, which it points at the context's card first.
    """
    import torch

    from ..core.dataset import build_training_dataset
    from ..core.dse import DSESettings, run_dse_sweep

    settings = settings or DSESettings(pop_size=16, n_gen=8)
    datasets: dict[str, object] = {}
    lock = threading.Lock()
    device = torch.device(settings.context.device)
    if device.type == "cuda" and device.index is None:   # the calling thread's card
        device = torch.device("cuda", torch.cuda.current_device())

    def runner(spec, app, method, const_sf_grid, seeds):
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with lock:
            ds = datasets.get(spec.tag)
            if ds is None:
                ds = datasets[spec.tag] = build_training_dataset(
                    spec, n_random=n_train, seed=0,
                    backend=settings.context,
                )
        app_obj = None
        if app is not None:
            from ..apps import APPLICATIONS

            app_obj = APPLICATIONS[app]()
        return run_dse_sweep(
            spec, ds, method, settings=settings, seeds=tuple(seeds),
            const_sf_grid=tuple(const_sf_grid), app=app_obj, store=store,
        )

    return runner


def _payload(req: DSERequest, res) -> dict:
    return {
        "status": "done",
        "request": dataclasses.asdict(req),
        "hv_vpf": float(res.hv_vpf),
        "hv_ppf": float(res.hv_ppf),
        "n_evals": int(res.n_evals),
        "wall_s": float(res.wall_s),
        "front": [[float(b), float(p)] for b, p in res.vpf_objs],
        "configs": ["".join(str(int(b)) for b in c) for c in res.vpf_configs],
    }


class DSEJobQueue:
    """Background worker coalescing pending DSE jobs into sweep dispatches.

    ``runner(spec, app, method, const_sf_grid, seeds) -> list[DSEResult]``
    must return lanes in sweep order (``for const_sf: for seed``) -- exactly
    :func:`repro_torch.core.dse.run_dse_sweep`'s contract.
    """

    def __init__(self, runner, tel=None, linger_s: float = 0.05,
                 max_batch: int = 64):
        self._runner = runner
        self._tel = tel
        self.linger_s = linger_s
        self.max_batch = max_batch
        self._lock = threading.Condition()
        self._pending: list[tuple[str, DSERequest]] = []
        self._results: dict[str, dict] = {}
        self._events: dict[str, threading.Event] = {}
        self._ids = itertools.count(1)
        self._closed = False
        self._worker = threading.Thread(
            target=self._drain_loop, name="dse-queue", daemon=True
        )
        self._worker.start()

    @property
    def tel(self):
        return self._tel if self._tel is not None else obs.current()

    # -- client API -----------------------------------------------------------

    def submit(self, req: DSERequest) -> str:
        """Enqueue one job; returns its id (poll with :meth:`result`)."""
        if self._closed:
            raise RuntimeError("queue is closed")
        with self._lock:
            job_id = f"job-{next(self._ids)}"
            self._events[job_id] = threading.Event()
            self._pending.append((job_id, req))
            tel = self.tel
            tel.count("service.jobs")
            tel.observe("service.queue_depth", float(len(self._pending)))
            self._lock.notify_all()
        return job_id

    def result(self, job_id: str, timeout: float | None = None) -> dict | None:
        """The job's payload dict, or None while still pending/unknown."""
        ev = self._events.get(job_id)
        if ev is None:
            return None
        if timeout:
            ev.wait(timeout)
        return self._results.get(job_id)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def join(self, timeout: float = 60.0) -> bool:
        """Block until every submitted job has a result (True) or timeout."""
        deadline = time.monotonic() + timeout
        for ev in list(self._events.values()):
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                return False
        return True

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._worker.join(timeout=5.0)

    # -- worker ---------------------------------------------------------------

    def _drain_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed and not self._pending:
                    return
            # linger: let a burst of compatible submissions pile up so they
            # coalesce into one dispatch instead of racing the worker
            time.sleep(self.linger_s)
            with self._lock:
                batch = self._pending[: self.max_batch]
                del self._pending[: len(batch)]
            if batch:
                self._dispatch(batch)

    def _dispatch(self, batch: list[tuple[str, DSERequest]]) -> None:
        groups: dict[tuple, list[tuple[str, DSERequest]]] = {}
        for job_id, req in batch:
            groups.setdefault(req.group, []).append((job_id, req))
        tel = self.tel
        for jobs in groups.values():
            req0 = jobs[0][1]
            sfs = sorted({j[1].const_sf for j in jobs})
            seeds = sorted({j[1].seed for j in jobs})
            tel.count("service.batches")
            tel.observe("service.batch_lanes", float(len(sfs) * len(seeds)))
            try:
                results = self._runner(
                    req0.spec(), req0.app, req0.method, sfs, seeds
                )
            except Exception as exc:   # a bad request must not kill the worker
                tel.count("service.job_errors", len(jobs))
                err = {"status": "error",
                       "error": f"{type(exc).__name__}: {exc}"}
                for job_id, req in jobs:
                    self._results[job_id] = dict(
                        err, request=dataclasses.asdict(req)
                    )
                    self._events[job_id].set()
                continue
            for job_id, req in jobs:
                lane = sfs.index(req.const_sf) * len(seeds) + seeds.index(
                    req.seed
                )
                self._results[job_id] = _payload(req, results[lane])
                self._events[job_id].set()
