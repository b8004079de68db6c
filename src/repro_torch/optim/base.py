"""Optimizer interface: functions over parameter trees.

Counterpart of ``repro/optim/base.py``.  A parameter tree is the model's
nested dict of tensors; an optimizer's state mirrors it (AdamW's ``{"m",
"v"}`` trees of f32 moments, Adafactor's per-leaf ``{"vr", "vc"}`` or
``{"v"}``), so a state converts from the reference's with
``convert.params_from_jax`` and a checkpoint carries across.
``state_spec`` maps the model's ``ParamSpec`` tree to the state's, as the
reference's does; the sharded train step places the state by it.

The port works in place where the reference builds new trees: ``update``
writes the new moments into the state's tensors and returns them, and
:func:`apply_updates` adds each update into its parameter under
``torch.no_grad()``.  At a full-width model a second copy of the f32 moments
would not fit beside the first.  Rounding is the reference's: the f32 update
is cast to the leaf's dtype, then added (``p + u.astype(p.dtype)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["Optimizer", "apply_updates", "spec_map", "tree_leaves", "tree_map"]


@dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, step) -> (updates, state);
    state_spec(spec_tree) -> the state's spec tree.

    ``updates`` are f32 deltas to *add* to params; ``step`` is the 0-based
    step count (an int).  ``update`` writes the new state into ``state``'s
    tensors and returns that same tree."""

    init: Callable
    update: Callable
    state_spec: Callable


def tree_leaves(tree) -> list:
    """Leaves of a nested dict tree, keys in sorted order (the order
    ``jax.tree.leaves`` gives a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of the nested dict ``tree`` and of the trees in
    ``rest``, which share its structure (``rest``'s may go deeper: their
    subtree at a leaf of ``tree`` is passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def spec_map(fn, spec_tree):
    """``fn`` over the ``ParamSpec`` leaves of a nested dict spec tree."""
    if isinstance(spec_tree, dict):
        return {k: spec_map(fn, v) for k, v in spec_tree.items()}
    return fn(spec_tree)


@torch.no_grad()
def apply_updates(params, updates):
    """``p += u.to(p.dtype)`` for every leaf, in place; returns ``params``."""
    tree_map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params
