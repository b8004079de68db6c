"""Atomic checkpointing of parameter and optimizer trees, in the reference's
on-disk layout.

Counterpart of ``repro/checkpoint/ckpt.py``.  One ``.npz`` per checkpoint
step holds every leaf under its tree path (``/stages/0/0/mixer/wq`` stored
as ``|stages|0|0|mixer|wq``), plus a JSON manifest (step, leaf paths,
dtypes, wall time).  Writes go to a temporary name and are ``os.replace``d,
so a crash mid-write never corrupts the latest checkpoint.  A leaf of a
dtype numpy lacks (bf16) is stored as its raw bytes with the dtype's name
in its key (``bfloat16::|...``) and decoded with torch (a ``uint16`` view
read as ``torch.bfloat16``), so a checkpoint written by either package
restores in the other, bit for bit.

Leaves are torch tensors, DTensors or numpy arrays. A DTensor leaf is saved
whole (``full_tensor``, a collective every rank of its mesh joins); in a
``torch.distributed`` world only rank 0 writes. ``restore_tree`` rebuilds
the template's structure: a tensor leaf of the template comes back as a
tensor on ``device`` (the card unless the caller says), a numpy leaf as a
numpy array; with target ``placements`` (a mesh and a placement tree) the
tensors come back as DTensors placed so, whatever world wrote them (the
reference's elastic restore onto other shardings). ``CheckpointManager``
adds retention, async save on a background thread and ``latest_step``
discovery for restarts; it snapshots every leaf to host memory in the
caller's thread before returning, because the optimizer updates the
parameters in place and the next step would otherwise race the writer.
In a world, ``wait`` and ``restore`` are collective: the other ranks wait
for rank 0's write and retention pass, and restore the step rank 0 names.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

from ..core.engine import ExecutionContext

__all__ = ["save_tree", "restore_tree", "place_tree", "latest_step", "CheckpointManager"]

BF16 = "bfloat16"   # the name a bf16 leaf's raw bytes are stored under


def _flatten_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _unflatten_like(template, values: dict, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_like(template[k], values, f"{prefix}/{k}") for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, values, f"{prefix}/{i}")
                              for i, v in enumerate(template))
    return values[prefix]


def _whole(v):
    """A DTensor leaf as its full value (a collective); others as they are."""
    from torch.distributed.tensor import DTensor

    return v.full_tensor() if isinstance(v, DTensor) else v


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a world, or alone."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _agreed(value):
    """Rank 0's ``value`` on every rank of a ``torch.distributed`` world (a
    broadcast every rank joins); alone, ``value`` itself."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _host(v) -> np.ndarray | torch.Tensor:
    """A host copy of a leaf that no later in-place update reaches."""
    if isinstance(v, torch.Tensor):
        return _whole(v.detach()).to("cpu", copy=True)
    return np.array(v, copy=True)


def _encode_leaf(v) -> tuple[np.ndarray, str]:
    """npz-compatible encoding: a bf16 leaf as its raw bytes, (..., 2) uint8."""
    if isinstance(v, torch.Tensor):
        v = _whole(v.detach()).cpu()
        if v.dtype == torch.bfloat16:
            raw = v.contiguous().view(torch.int16).numpy().reshape(-1).view(np.uint8)
            return raw.reshape(tuple(v.shape) + (2,)), BF16
        return v.numpy(), ""
    return np.asarray(v), ""


def _decode_leaf(raw: np.ndarray, dtype_name: str):
    """A stored leaf: numpy for numpy dtypes, a CPU tensor for bf16."""
    if not dtype_name:
        return raw
    if dtype_name != BF16:
        raise ValueError(f"no decoding for a leaf stored as {dtype_name!r}")
    words = np.ascontiguousarray(raw).view(np.int16).reshape(raw.shape[:-1])
    return torch.from_numpy(words).view(torch.bfloat16)


def save_tree(path: str, step: int, tree, extra: dict | None = None) -> None:
    """Atomic save of a tree (+ manifest) to ``<path>/step_<step>.npz``;
    every rank encodes (DTensors gather), rank 0 writes."""
    encoded = [(k, _encode_leaf(v)) for k, v in _flatten_with_paths(tree)]
    if not _writer():
        return
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for k, (enc, dtype_name) in encoded:
        key = k.replace("/", "|")
        arrays[f"{dtype_name}::{key}" if dtype_name else key] = enc

    npz_tmp = os.path.join(path, f"step_{step:08d}.npz.tmp.npz")
    npz_final = os.path.join(path, f"step_{step:08d}.npz")
    np.savez(npz_tmp, **arrays)
    os.replace(npz_tmp, npz_final)

    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "time": time.time(),
        "extra": extra or {},
    }
    man_tmp = os.path.join(path, f"step_{step:08d}.json.tmp")
    man_final = os.path.join(path, f"step_{step:08d}.json")
    with open(man_tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(man_tmp, man_final)


def _steps(path: str) -> list[int]:
    return [int(f[len("step_"):-len(".json")]) for f in os.listdir(path)
            if f.startswith("step_") and f.endswith(".json")]


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return max(steps) if steps else None


def restore_tree(path: str, step: int, template, device=None, dtypes=None,
                 placements=None):
    """Restore into the structure of ``template``: a tensor leaf of the
    template as a tensor on ``device`` (the card by default), a numpy leaf as
    a numpy array; ``dtypes``, a tree of torch dtypes, casts the tensors.
    ``placements`` = (mesh, a tree of DTensor placements mirroring the
    template) returns DTensors placed so, each rank keeping its shard."""
    npz = os.path.join(path, f"step_{step:08d}.npz")
    values = {}
    with np.load(npz) as z:
        for k in z.files:
            dtype_name, _, key = k.rpartition("::")
            values[key.replace("|", "/")] = _decode_leaf(z[k], dtype_name)
    paths = dict(_flatten_with_paths(template))
    dev = (ExecutionContext(device=device).device
           if any(isinstance(t, torch.Tensor) for t in paths.values()) else None)

    def place(t, v):
        if isinstance(t, torch.Tensor):
            return (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(dev)
        return v.numpy() if isinstance(v, torch.Tensor) else v

    placed = {p: place(t, values[p]) for p, t in paths.items()}
    if dtypes is not None:
        placed = {p: placed[p].to(d) for p, d in _flatten_with_paths(dtypes)}
    tree = _unflatten_like(template, placed)
    if placements is not None:
        tree = place_tree(tree, *placements)
    return tree


def place_tree(tree, mesh, placements):
    """Full tensors (the same on every rank) -> DTensors with ``placements``
    (a tree mirroring ``tree``) on ``mesh``; each rank cuts its shard."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: place_tree(tree[k], mesh, placements[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(t, mesh, p) for t, p in zip(tree, placements))
    return distribute_tensor(tree, mesh, placements, src_data_rank=None)


class CheckpointManager:
    """Retention + async save + restart discovery."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = True):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def latest_step(self) -> int | None:
        return latest_step(self.path)

    def wait(self) -> None:
        """Join the background save; re-raise its failure, if it had one.

        In a world every rank calls it: rank 0, the writer, joins its thread
        (the write and the retention pass) and then tells every rank whether
        it failed, so all ranks leave together and raise together."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _agreed(self._error is not None):
            err, self._error = self._error, None
            raise err if err is not None else RuntimeError(
                "the checkpoint write on rank 0 failed")

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        # host copies before returning: the caller updates the tree in place
        host_tree = _unflatten_like(tree, {p: _host(v) for p, v in _flatten_with_paths(tree)})

        if not _writer():
            return

        def work():
            try:
                save_tree(self.path, step, host_tree, extra)
                self._gc()
            except BaseException as exc:  # noqa: BLE001 -- handed to wait()
                self._error = exc

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def restore(self, template, step: int | None = None, device=None, dtypes=None,
                placements=None):
        """(tree, step) of ``step`` (the latest by default), or (None, None).
        In a world every rank calls it: pending writes finish first, and the
        latest step is rank 0's, so every rank restores the same one."""
        self.wait()
        step = _agreed(self.latest_step()) if step is None else step
        if step is None:
            return None, None
        return restore_tree(self.path, step, template, device, dtypes, placements), step

    def _gc(self) -> None:
        steps = sorted(_steps(self.path))
        for s in steps[: -self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.path, f"step_{s:08d}{ext}"))
                except FileNotFoundError:
                    pass
