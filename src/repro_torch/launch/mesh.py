"""Production meshes on a ``torch.distributed`` world.

Counterpart of ``repro/launch/mesh.py``: a function, not a module constant,
so importing this module touches no process group.  The world must be set up
first (``torch.distributed.init_process_group``, with its address, world
size and rank given explicitly).  The reference's mesh takes the first
devices of a larger host; ``init_device_mesh`` spans the whole world, so a
world of another size than the mesh raises.
"""

from __future__ import annotations

import math

__all__ = ["make_production_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]

POD_SHAPE = (16, 16)                    # 256 cards a pod
MULTIPOD_SHAPE = (2, 16, 16)            # 2 pods = 512 cards


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``("data", "model")`` (16, 16), or ``("pod", "data", "model")``
    (2, 16, 16) with ``multi_pod``; raises on a world of another size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a world of {need} ranks, it has {have} -- start "
            f"{need} processes (torch.distributed.init_process_group with world_size={need})"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)
