"""Global-norm gradient clipping.

Counterpart of ``repro/optim/clip.py``: the norm over every leaf in f32, and
each leaf scaled in f32 and cast back to its dtype.
"""

from __future__ import annotations

import torch

from .base import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of every leaf's squared f32 entries), a 0-d f32 tensor."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(leaf.to(torch.float32) ** 2) for leaf in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale).to(leaf.dtype), tree), norm
