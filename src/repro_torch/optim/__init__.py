"""Optimizers and gradient numerics for training.

Counterpart of ``repro/optim/``: AdamW and Adafactor over the model's
parameter tree, the cosine schedule, global-norm clipping and the int8
accumulator compression, and ``compressed_psum``, the int8 data-parallel
reduction over a process group.  ``Optimizer.state_spec`` maps the model's
spec tree to the state's, which places the state on a mesh.
"""

from .adafactor import adafactor
from .adamw import adamw
from .base import Optimizer, apply_updates, tree_leaves, tree_map
from .clip import clip_by_global_norm, global_norm
from .compress import compress_int8, compressed_psum, decompress_int8
from .schedule import cosine_schedule

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "cosine_schedule",
    "compress_int8",
    "compressed_psum",
    "decompress_int8",
    "make_optimizer",
    "tree_leaves",
    "tree_map",
]


def make_optimizer(name: str, lr_fn, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr_fn, **kw)
    if name == "adafactor":
        return adafactor(lr_fn, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
