"""Checkpointing: atomic saves in the reference's layout, async retention."""

from .ckpt import CheckpointManager, latest_step, restore_tree, save_tree

__all__ = ["CheckpointManager", "latest_step", "save_tree", "restore_tree"]
