"""int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compress.py``, its accumulator form: a
gradient-accumulation buffer stored as int8 with a per-tensor f32 scale and
an f32 error-feedback residual that re-enters the next microbatch.  The
reference's ``compressed_psum`` is a ``shard_map`` collective over a
data-parallel mesh axis; it waits with the other multi-card paths
(ROADMAP.md queue 1 item 13).  ``torch.round`` rounds half to even, as
``jnp.round`` does, so the codes are the reference's.
"""

from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8"]


def compress_int8(x: torch.Tensor, error: torch.Tensor | None = None):
    """x (+ carried error) -> (q int8, scale f32 0-d, new_error f32)."""
    xf = x.to(torch.float32)
    if error is not None:
        xf = xf + error
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    new_error = xf - q.to(torch.float32) * scale
    return q, scale, new_error


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
