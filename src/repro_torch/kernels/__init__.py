"""Hand-written CUDA kernels of the port, each beside its plain PyTorch version.

The kernel modules (``char_kernels``, ``moo_kernels``, ``app_kernels``,
``axo_matmul``, ``flash_attention``, ``ssd_scan``) build their ``csrc/``
sources on first use.  Every implementation registers in the **kernel
registry** (``registry``: its tunable launch parameters, defaults,
constraints, cost formula and plain version), whose tiles the **autotuner**
(``tuning``) searches per (device, shape bucket) under an
``ExecutionContext(tuning=...)`` policy; ``registry.describe()`` lists them.
"""

from . import registry, tuning

__all__ = ["registry", "tuning"]
