"""Device taps: rows staged on the card, drained into a telemetry's series.

Counterpart of ``repro/obs/device.py``.  The reference's tap stages a
``jax.experimental.io_callback`` inside a jitted loop, so that a compiled
program emits one host record a firing.  The port has no compiled program:
its loops issue tensor operations from the host, and what a tap must not do
is make that host wait for the card.  A tap here therefore takes device
tensors and **does not synchronize when it fires**:

  * the firing's values are stacked into a row (or a chunk of rows) on
    their device, copied to pinned host memory with ``non_blocking=True``,
    and a CUDA event is recorded behind the copy;
  * the row waits in a pending list until its event has completed; every
    firing drains the pending rows whose events have completed
    (``Event.query``, which does not block), and :func:`flush` waits for
    the rest and drains them.  A chunked tap (:func:`make_batched_tap`)
    thereby drains at chunk boundaries, as the reference's batched tap
    flushes there.

Each drained row becomes one record ``{field: value, ..., "_host_t":
perf_counter}`` in ``tel.series[name]`` and one count of ``tap.<name>``.  On
a CPU tensor the copy is a plain one and the row is ready at once.  A
disabled telemetry hands out :func:`null_tap`, which stages nothing.

Call :func:`flush` before reading a series.
"""

from __future__ import annotations

import threading
import time

import torch

__all__ = ["make_tap", "make_batched_tap", "null_tap", "flush"]

# staged rows not drained yet: (tel, name, fields, host rows, host valid, event)
_PENDING: list = []
_LOCK = threading.Lock()


def null_tap(*args, **kwargs) -> None:
    """The disabled tap: stages nothing."""
    return None


def _drain(entry) -> None:
    tel, name, fields, rows, valid, _ = entry
    for row in rows.numpy()[valid.numpy()]:
        rec = {f: v for f, v in zip(fields, row)}
        rec["_host_t"] = time.perf_counter()
        tel.emit(name, rec)
        tel.count(f"tap.{name}")


def _drain_ready() -> None:
    """Drain the pending rows whose copies have completed, in firing order,
    without waiting for the others."""
    with _LOCK:
        ready = 0
        while ready < len(_PENDING) and (_PENDING[ready][5] is None
                                         or _PENDING[ready][5].query()):
            ready += 1
        done = _PENDING[:ready]
        del _PENDING[:ready]
    for entry in done:
        _drain(entry)


def _stage(tel, name: str, fields: tuple, rows: torch.Tensor, valid: torch.Tensor) -> None:
    """Copy (C, F) f32 ``rows`` and (C,) bool ``valid`` to host memory behind
    an event and queue them for draining; no host sync."""
    event = None
    if rows.is_cuda:
        host_rows = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host_valid = torch.empty(valid.shape, dtype=valid.dtype, pin_memory=True)
        host_rows.copy_(rows, non_blocking=True)
        host_valid.copy_(valid, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(rows.device))
    else:
        host_rows, host_valid = rows.clone(), valid.clone()
    with _LOCK:
        _PENDING.append((tel, name, fields, host_rows, host_valid, event))
    _drain_ready()


def make_tap(tel, name: str, fields: tuple):
    """A tap ``tap(*values)``: one row of ``len(fields)`` values a firing.

    Values may be 0-d tensors (on any one device) or Python numbers; they
    are stacked into an f32 row on the tensors' device.
    """

    def tap(*vals):
        if len(vals) != len(fields):
            raise TypeError(f"tap {name!r} expects {len(fields)} values {fields}, "
                            f"got {len(vals)}")
        dev = next((v.device for v in vals if isinstance(v, torch.Tensor)),
                   torch.device("cpu"))
        row = torch.stack([
            v.to(torch.float32).reshape(()) if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=torch.float32, device=dev)
            for v in vals
        ])[None]
        _stage(tel, name, fields, row, torch.ones(1, dtype=torch.bool, device=dev))

    tap.fields = fields
    tap.series = name
    return tap


def make_batched_tap(tel, name: str, fields: tuple):
    """A tap ``tap(rows, valid)``: a (C, len(fields)) f32 chunk of rows a
    firing, of which the rows where the (C,) ``valid`` is false are dropped
    (a ragged last chunk passes a mask).  Each valid row is drained as one
    record, as C firings of :func:`make_tap` would be."""

    def tap(rows: torch.Tensor, valid: torch.Tensor):
        if rows.dim() != 2 or rows.shape[1] != len(fields):
            raise TypeError(f"tap {name!r} expects (C, {len(fields)}) rows {fields}, "
                            f"got {tuple(rows.shape)}")
        _stage(tel, name, fields, rows.to(torch.float32), valid.to(torch.bool))

    tap.fields = fields
    tap.series = name
    return tap


def flush() -> None:
    """Wait for every staged row's copy and drain it into its series."""
    with _LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    for entry in pending:
        if entry[5] is not None:
            entry[5].synchronize()
        _drain(entry)
