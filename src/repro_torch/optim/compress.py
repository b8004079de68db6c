"""int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compress.py``.  Two forms:

* the accumulator: a gradient-accumulation buffer stored as int8 with a
  per-tensor f32 scale and an f32 error-feedback residual that re-enters the
  next microbatch;
* :func:`compressed_psum`, a two-phase data-parallel reduction over a
  ``torch.distributed`` process group (the reference's ``shard_map``
  collective over a mesh axis): an all-reduce MAX of the per-rank absmax,
  quantization with the shared scale, an all-reduce SUM in int32, and
  dequantization.  It needs only all-reduce, so it runs on gloo with CUDA
  tensors too.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the codes are
the reference's.
"""

from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "compressed_psum"]


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


def compressed_psum(x: torch.Tensor, group=None):
    """int8-compressed sum over ``group`` -> (reduced f32 tensor, this rank's
    quantization error for error feedback).

    Exact with respect to the shared scale; the wire carries one int32 per
    element plus one scalar (the reference's psum of int32 codes).
    """
    import torch.distributed as dist

    xf = x.to(torch.float32)
    gmax = torch.max(torch.abs(xf)).reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax[0], min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    # XLA fuses the residual into one multiply-add (one rounding); q * scale
    # is exact in f64, so this rounds once too and the residual is the reference's
    err = (xf.double() - q.double() * scale.double()).to(torch.float32)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale, err
