"""PyTorch/CUDA port of the AxOMaP DSE stack for the NVIDIA H100.

Counterpart of the JAX package ``repro``, module for module; it imports
neither JAX nor ``repro``.  The main path is ``repro_torch.core.dse.run_dse``.
"""
