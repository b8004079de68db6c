"""Causal GQA flash attention, kernel K7, beside its plain version.

``flash_attention`` replaces ``repro/kernels/flash_attention_kernel.py::
flash_attention_pallas``; the CUDA source is ``csrc/flash_attention.cu``,
whose header says what bounds it on the H100 and how the design answers it.
It computes, for q (B, H, Sq, hd) and k, v (B, G, Skv, hd),

    out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h // (H/G), j]) v[b, h // (H/G), j]

over the keys ``j < kv_len`` and, when causal, ``j <= q_offset + i``: query row
i sits at absolute position ``q_offset + i``, as in the model's prefill into
a KV cache (``models.attention.attn_apply``).  ``q_offset`` and ``kv_len`` are
runtime arguments.  Every tensor may be a strided view whose head dimension
is contiguous (the model passes ``(B, S, H, hd)`` activations and its cache
transposed); the output has ``q``'s layout.

The plain version is ``ref.ref_flash_attention``'s direct masked softmax with
the offset and ``kv_len`` added, computed in f32 and rounded once to the input
type.  The bf16 kernel runs both products on the tensor cores and carries its
softmax weights as a bf16 hi + lo pair (``tests/test_torch_kernel_design.py``
emulates that in plain torch); the f32 kernel keeps them in f32.  For bf16
every row of q, k, v and the output must start on a 16-byte boundary: the
kernel copies K/V rows in 16-byte pieces, its launcher refuses a view that
breaks that, and the wrapper raises.  The kernel is built for the head widths
in ``HEAD_DIMS``: granite's 64, the reduced configs' 16, internlm2's,
starcoder2's and deepseek-67b's 128, and kimi-k2's 112; another width raises.
On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.  ``flash_attention.launches`` counts kernel
launches.

Training takes K7 through :class:`FlashAttentionFn`, an autograd function:
its forward is ``flash_attention`` (K7 on the card, the plain version on a
CPU tensor) and its backward recomputes ``flash_attention_plain`` on the
saved inputs and differentiates it.  That backward is the reference's own
math: the reference trains through its XLA ``chunked_attention`` and has no
backward kernel, so the gradient is autodiff of the plain softmax algebra.
It is not a fallback: the forward never gives way to the plain version on
the card.  ``flash_attention`` takes that route itself where a gradient is
wanted (grad mode on and an input that requires grad, on a CUDA tensor):
the kernel's output carries no ``grad_fn``, so no caller may reach the raw
launch with such inputs, and none has to know the rule.
``FlashAttentionFn.forward`` runs with grad off and so reaches the launch.

The first launch of a (Sq, kv_len) that the current telemetry sees records
its pad-to-tile waste over K7's 64 x 64 (query, key) tiles there as
``flash_attention.pad_waste``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..obs.telemetry import current, record_pad_waste
from . import build

__all__ = ["flash_attention", "flash_attention_plain", "FlashAttentionFn", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 112, 128)   # head widths the kernel is built for
TILE = 64                  # query rows and keys of a block's tiles (csrc kBQ, kBK)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MISALIGNED = -1           # the launcher's answer to a bf16 row off a 16-byte boundary


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None,
                          q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Plain version of K7: the direct masked softmax, (B, H, Sq, hd)."""
    b, h, sq, hd = q.shape
    g, skv = k.shape[1], k.shape[2]
    rep = h // g
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    kv_len = skv if kv_len is None else kv_len
    kh = k.to(torch.float32).repeat_interleave(rep, dim=1)
    vh = v.to(torch.float32).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kh) * scale
    kpos = torch.arange(skv, device=q.device)
    valid = (kpos < kv_len)[None, :]
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        valid = valid & (qpos[:, None] >= kpos[None, :])
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vh).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [
        p, p, p, p, ctypes.POINTER(ctypes.c_longlong), i, i, i, i, i, i,
        ctypes.c_float, i, i, i, p,
    ]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           kv_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H|G, S, hd)")
    b, h, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads do not split into {k.shape[1]} KV groups")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v are on different devices")
    if not 0 <= kv_len <= k.shape[2] or q_offset < 0:
        raise ValueError(f"kv_len {kv_len} must lie in [0, {k.shape[2]}] and "
                         f"q_offset {q_offset} must be >= 0")


def _record_pad(sq: int, kv_len: int) -> None:
    """Pad waste of K7's (query, key) iteration space, once a shape on the
    current telemetry."""
    if current().first(("flash_attention", sq, kv_len)):
        record_pad_waste("flash_attention", (sq, kv_len),
                         (-(-sq // TILE) * TILE, -(-kv_len // TILE) * TILE))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """K7: q (B, H, Sq, hd), k/v (B, G, Skv, hd) f32 or bf16 -> (B, H, Sq, hd).

    Where a gradient is wanted on a CUDA tensor it runs as
    :class:`FlashAttentionFn` (K7 forward, the plain version's backward).
    """
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_len)
    _record_pad(q.shape[2], kv_len)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, q_offset, kv_len)
    b, h, sq, hd = q.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K7 is built for head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dimension")
    scale = (1.0 / math.sqrt(hd)) if scale is None else float(scale)
    out = torch.empty_like(q)   # q's layout: dense with a contiguous head dim
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in (t.stride(0), t.stride(1), t.stride(2))
    ))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        _DTYPES[q.dtype], b, h, k.shape[1], sq, hd, scale, int(causal), q_offset,
        kv_len, stream,
    )
    if err == _MISALIGNED:
        raise ValueError("K7 in bf16 needs every row of q, k, v and out on a 16-byte "
                         "boundary: data at " + ", ".join(
                             f"{t.data_ptr():#x} strides {tuple(t.stride())}"
                             for t in (q, k, v, out)))
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K7 under autograd: ``apply(q, k, v, causal, scale, q_offset, kv_len)``.

    The forward runs ``flash_attention``; the backward differentiates
    ``flash_attention_plain`` recomputed on the saved q, k and v.  q, k and v
    as ``flash_attention`` takes them, causal or not, at any Sq and Skv.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None, q_offset=0, kv_len=None):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wrt = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            out = flash_attention_plain(*inputs, **ctx.kw)
        grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None)
