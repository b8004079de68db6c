from .synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
