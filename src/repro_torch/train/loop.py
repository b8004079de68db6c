"""Fault-tolerant training loop, on one device or a mesh.

Counterpart of ``repro/train/loop.py``:

* **checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps
  (async write); on any step failure the loop restores the latest checkpoint
  and replays -- the seekable data pipeline makes the replay repeat the
  uninterrupted run's steps.
* **straggler detection**: per-step wall time against a running median;
  steps slower than ``straggler_factor`` x median are counted and reported
  through ``on_straggler``.
* **fault injection**: ``fault_hook(step)`` may raise to simulate a node loss.

``placements`` = (mesh, parameter placements, optimizer-state placements)
is the reference's ``shardings``: after a restore the state is re-placed
onto that mesh, so a checkpoint written by one world (or one device)
resumes on another (elastic restore).  Without it a checkpoint restores onto
the device of the state the loop started from.  In a ``torch.distributed``
world every rank runs the loop: rank 0 writes, and after a fault every rank
waits for that write and restores the step rank 0 names
(``CheckpointManager.restore``), so the ranks replay from one step.
"""

from __future__ import annotations

import logging
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from ..checkpoint import CheckpointManager
from ..checkpoint.ckpt import _flatten_with_paths

log = logging.getLogger("repro_torch.train")

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                                               "repro_torch_ckpt"))
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10
    async_ckpt: bool = True


def _device_of(tree):
    """The device of the tree's first tensor leaf (None for a tree without one)."""
    return next((v.device for _, v in _flatten_with_paths(tree)
                 if isinstance(v, torch.Tensor)), None)


def train_loop(
    step_fn: Callable,            # (params, opt_state, step, batch) -> (p, o, metrics)
    init_state: Callable,         # () -> (params, opt_state)   (fresh init)
    batch_fn: Callable,           # step -> batch
    cfg: TrainLoopConfig,
    fault_hook: Callable | None = None,  # step -> None (raise to inject a fault)
    on_straggler: Callable | None = None,
    on_metrics: Callable | None = None,
    placements: tuple | None = None,     # (mesh, param, opt-state placements)
):
    """Run to ``total_steps`` with checkpoint/restart.  Returns the final
    state, the (step, loss) history and the restart and straggler counts."""
    mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep, async_save=cfg.async_ckpt)

    def restore(state):
        target = None if placements is None else (placements[0], placements[1:])
        return mgr.restore(state, device=_device_of(state), placements=target)

    params, opt_state = init_state()
    start = 0
    restored, step0 = restore((params, opt_state))
    if restored is not None:
        params, opt_state = restored
        start = step0 + 1
        log.info("restored checkpoint at step %d", step0)

    history: list[tuple[int, float]] = []
    durations: list[float] = []
    restarts = 0
    stragglers = 0

    step = start
    while step < cfg.total_steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            t0 = time.time()
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, step, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            durations.append(dt)

            if len(durations) >= 5:
                med = statistics.median(durations[-50:])
                if dt > cfg.straggler_factor * med:
                    stragglers += 1
                    log.warning("straggler step %d: %.3fs vs median %.3fs", step, dt, med)
                    if on_straggler is not None:
                        on_straggler(step, dt, med)

            history.append((step, loss))
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % cfg.log_every == 0:
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.total_steps:
                mgr.save(step, (params, opt_state))
            step += 1
        except KeyboardInterrupt:
            raise
        except Exception as exc:  # noqa: BLE001 -- any node fault
            restarts += 1
            log.error("step %d failed (%s); restart %d/%d", step, exc, restarts,
                      cfg.max_restarts)
            if restarts > cfg.max_restarts:
                raise
            restored, step0 = restore((params, opt_state))   # after pending writes
            if restored is None:
                params, opt_state = init_state()
                step = 0
            else:
                params, opt_state = restored
                step = step0 + 1
            # drop history at/after the replay point so records stay consistent
            history = [(s, l) for (s, l) in history if s < step]

    mgr.wait()
    return {
        "params": params,
        "opt_state": opt_state,
        "history": history,
        "restarts": restarts,
        "stragglers": stragglers,
    }
