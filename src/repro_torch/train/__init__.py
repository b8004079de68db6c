"""The fault-tolerant training loop."""

from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainLoopConfig", "train_loop"]
