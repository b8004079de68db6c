"""Mamba-2 chunked SSD scan, kernel K8, beside its plain version.

``ssd_scan`` replaces ``repro/kernels/ssd_scan_kernel.py::ssd_scan_pallas``;
the CUDA source is ``csrc/ssd_scan.cu``, whose header says what bounds it on
the H100 and how the design answers it.  For x (B, S, H, P), dt (B, S, H),
a (H,) and B, C (B, S, G, N) it computes the state-space recurrence

    state_t = exp(dt_t a_h) state_{t-1} + dt_t x_t B_t^T,    y_t = state_t C_t

per head h, which reads group ``h // (H/G)``, from ``init_state`` (or zeros).
It returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N) in
f32.  x, B and C may be strided views whose last axis is contiguous (the
model passes views into its in_proj output).

The plain version is ``repro/models/ssm.py::ssd_chunked``'s chunked algebra
in torch: S padded to a multiple of the chunk (padding counts as dt = 0,
x = 0, which leaves the state unchanged), the intra-chunk quadratic term, the
chunk states, their recurrence and the cross-chunk term, each einsum
contracted pairwise so that no (B, nc, H, Q, Q, P) intermediate exists.  Like
the Pallas kernel and K8, it contracts in f32 (the reference's XLA path keeps
bf16 scores for bf16 inputs) and rounds y once.  The kernel walks its own
32-position chunks (``CHUNK``): the chunked algebra is exact for any chunk
length, so the two differ only by rounding.  On a CPU tensor the wrapper
returns the plain version; on a CUDA tensor it launches the kernel or raises.

The kernel has two designs (``route``), chosen by dtype.  bf16 takes the
tensor-core design, two grids a call: the scores C B^T once per group, then
the scan, with the state's rows split into slices that share each chunk's
operands three to a block, and every f32 operand fed to the tensor cores as
three bf16 terms.  Its x, B and C rows must be 16-byte aligned (pointers and
(batch, position, head|group) strides), and the wrapper raises where they are
not.  f32 takes the first design on the f32 pipe, one grid.
``ssd_scan.launches`` counts calls, ``ssd_scan.route_launches`` the
calls by route, and ``grids()`` the grids the library has launched.  ``ssd_scan_scalar`` runs the first design on bf16 as well,
so that the card's checks can time it beside the new one; it counts its own
launches.

Training takes K8 through :class:`SSDScanFn`, an autograd function with two
outputs, y and the final state: its forward is ``ssd_scan`` (K8 on the card,
the plain version on a CPU tensor) and its backward recomputes
``ssd_scan_plain`` at the model's chunk on the saved inputs and
differentiates it.  That backward is the reference's own math: the
reference trains through its XLA ``ssd_chunked`` and has no backward
kernel, so the gradient is autodiff of the plain chunked algebra.  It is
not a fallback: the forward never gives way to the plain version on the
card.  ``ssd_scan`` takes that route itself where a gradient is wanted (grad
mode on and an input that requires grad, on a CUDA tensor): the kernel's
outputs carry no ``grad_fn``, so no caller may reach the raw launch with
such inputs, and none has to know the rule (``SSDScanFn.forward`` runs with
grad off and so reaches the launch).  ``ssd_scan_scalar``, which has no
autograd function, refuses such inputs.

The card's entry is the custom op ``torch.ops.repro_torch.ssd_scan`` (CUDA
only), which ``ssd_scan`` calls on a CUDA tensor and whose implementation
is the raw launcher, :func:`ssd_scan_raw` (the route by dtype, the launch
and its counts).  The op has a fake implementation (y and the f32 state,
no launch), so a step traced on fake tensors (``launch.lowering``) passes
through it, and a FLOP formula, the registry's ``cost_fn`` at the model's
chunk, so ``torch.utils.flop_counter`` counts the kernel's work.  The
16-byte alignment of bf16 rows is checked by the raw launcher (a fake
tensor has no address).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from torch.utils.flop_counter import register_flop_formula

from . import build

__all__ = ["ssd_scan", "ssd_scan_scalar", "ssd_scan_plain", "ssd_scan_raw", "SSDScanFn",
           "route", "grids", "segsum", "HEAD_DIMS", "STATE_DIMS", "CHUNK"]

HEAD_DIMS = (8, 16, 32, 64)            # P values the kernel is built for
STATE_DIMS = (8, 16, 32, 64, 128)      # N values
CHUNK = 32                             # the kernel's own chunk length (kQ)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q) with out[i, j] = sum_{j < k <= i} x[k]; -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, chunk: int = 128,
                   init_state: torch.Tensor | None = None):
    """Plain version of K8: the chunked SSD in torch, (y, final state)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    f32 = torch.float32
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        bmat = torch.nn.functional.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = torch.nn.functional.pad(cmat, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // q
    # heads split as (group, head within the group): head = g * rep + r
    xc = x.to(f32).reshape(b, nc, q, g, rep, p)
    dtc = dt.to(f32).reshape(b, nc, q, h)
    bc = bmat.to(f32).reshape(b, nc, q, g, n)
    cc = cmat.to(f32).reshape(b, nc, q, g, n)

    da = dtc * a.to(f32)
    da_cs = torch.cumsum(da, dim=2)                                   # (B, nc, Q, H)

    # 1) intra-chunk: ((C B^T) o L) dt, then x
    decay = torch.exp(segsum(da.transpose(2, 3)))                     # (B, nc, H, Ql, Qs)
    scores = torch.einsum("bclgn,bcsgn->bcgls", cc, bc)               # (B, nc, G, Ql, Qs)
    m = scores[:, :, :, None] * decay.reshape(b, nc, g, rep, q, q)
    m = m * dtc.transpose(2, 3).reshape(b, nc, g, rep, 1, q)
    y_diag = torch.einsum("bcgrls,bcsgrp->bclgrp", m, xc)
    del decay, m

    # 2) each chunk's own state: B^T (decay-to-end * dt * x)
    w = (torch.exp(da_cs[:, :, -1:] - da_cs) * dtc).reshape(b, nc, q, g, rep, 1)
    states = torch.einsum("bcsgn,bcsgrp->bcgrpn", bc, xc * w)         # (B, nc, G, R, P, N)

    # 3) the recurrence over chunks, keeping the state entering each chunk
    chunk_decay = torch.exp(da_cs[:, :, -1]).reshape(b, nc, g, rep, 1, 1)
    st = (torch.zeros((b, g, rep, p, n), dtype=f32, device=x.device) if init_state is None
          else init_state.to(f32).reshape(b, g, rep, p, n))
    entering = []
    for c in range(nc):
        entering.append(st)
        st = st * chunk_decay[:, c] + states[:, c]
    prev = torch.stack(entering, dim=1)                               # (B, nc, G, R, P, N)

    # 4) cross-chunk: C . state entering the chunk, decayed to each position
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", cc, prev)
    y_off = y_off * torch.exp(da_cs).reshape(b, nc, q, g, rep, 1)
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), st.reshape(b, h, p, n)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.library("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    ll = ctypes.POINTER(ctypes.c_longlong)
    lib.ssd_scan_scalar_launch.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, i, p]
    lib.ssd_scan_scalar_launch.restype = ctypes.c_int
    lib.ssd_scan_mma_launch.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, i, i, i, p]
    lib.ssd_scan_mma_launch.restype = ctypes.c_int
    lib.ssd_scan_grids.argtypes = []
    lib.ssd_scan_grids.restype = ctypes.c_longlong
    return lib


def grids() -> int:
    """Grids the CUDA library has launched, both designs, since it was loaded
    (it is built and loaded on the first call: the card's checks only)."""
    return int(_lib().ssd_scan_grids())


def _check(x, dt, a, bmat, cmat, init_state) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 4:
        raise ValueError("x must be (B, S, H, P), dt (B, S, H), a (H,), B and C (B, S, G, N)")
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if dt.shape != (b, s, h) or a.shape != (h,) or cmat.shape != bmat.shape \
            or bmat.shape[:2] != (b, s):
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads do not split into {g} groups")
    if init_state is not None and init_state.shape != (b, h, p, n):
        raise ValueError(f"init_state must be {(b, h, p, n)}, got {tuple(init_state.shape)}")
    tensors = [x, dt, a, bmat, cmat] + ([] if init_state is None else [init_state])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the SSD scan's inputs are on different devices")
    if not x.dtype == bmat.dtype == cmat.dtype:
        raise TypeError(f"x, B, C dtypes differ: {x.dtype}, {bmat.dtype}, {cmat.dtype}")
    if not x.is_floating_point() or not dt.is_floating_point() or not a.is_floating_point():
        raise TypeError("the SSD scan takes floating-point inputs")


def _check_card(x, dt, a, bmat, cmat, init_state) -> None:
    """What the CUDA kernel takes, beyond what the plain version does."""
    if _grad_wanted(x, dt, a, bmat, cmat, init_state):
        raise RuntimeError("K8's outputs carry no gradient: take SSDScanFn.apply for inputs "
                           "that require grad, or run under torch.no_grad()")
    p, n = x.shape[3], bmat.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"K8 takes float32 or bfloat16 x, B and C, got {x.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or (
            init_state is not None and init_state.dtype != torch.float32):
        raise TypeError("K8 takes float32 dt, a and init_state")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"K8 is built for P in {HEAD_DIMS} and N in {STATE_DIMS}, "
                         f"got P={p}, N={n}")
    if any(t.stride(-1) != 1 for t in (x, bmat, cmat)) or a.stride(0) != 1 or (
            init_state is not None and not init_state.is_contiguous()):
        raise ValueError("K8 needs x, B and C with a contiguous last axis, and a and "
                         "init_state contiguous")


def _check_aligned(x, bmat, cmat) -> None:
    if x.dtype == torch.bfloat16 and not all(
            t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
            for t in (x, bmat, cmat)):
        raise ValueError("K8 in bf16 needs every row of x, B and C on a 16-byte boundary "
                         "(pointers, and batch, position and head|group strides in "
                         "multiples of 8)")


def _grad_wanted(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in tensors)


def route(x: torch.Tensor) -> str:
    """K8's design for x's dtype: ``"mma"`` (bf16) or ``"scalar"`` (f32)."""
    return "mma" if x.dtype == torch.bfloat16 else "scalar"


def _launch(design, x, dt, a, bmat, cmat, init_state):
    """(y, final state, whether a kernel was launched: not for empty outputs)."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if y.numel() == 0 and state.numel() == 0:
        return y, state, False
    strides = (ctypes.c_longlong * 12)(*(
        st for t in (x, dt, bmat, cmat) for st in (t.stride(0), t.stride(1), t.stride(2))
    ))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    init = None if init_state is None else init_state.data_ptr()
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), init,
            y.data_ptr(), state.data_ptr())
    if design == "mma":
        scores = torch.empty((b, -(-s // CHUNK), g, CHUNK, CHUNK), dtype=torch.float32,
                             device=x.device)
        err = _lib().ssd_scan_mma_launch(*ptrs, scores.data_ptr(), strides, b, s, h, g, p, n,
                                         stream)
    else:
        err = _lib().ssd_scan_scalar_launch(*ptrs, strides, _DTYPES[x.dtype], b, s, h, g, p, n,
                                            stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan ({design} design) launch failed: cudaError {err}")
    return y, state, True


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, chunk: int = 128, init_state: torch.Tensor | None = None):
    """K8: (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32).

    ``chunk`` is the plain version's chunk length; the kernel walks its own.
    Where a gradient is wanted on a CUDA tensor it runs as :class:`SSDScanFn`
    (K8 forward, the plain version's backward).
    """
    _check(x, dt, a, bmat, cmat, init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, init_state=init_state)
    if _grad_wanted(x, dt, a, bmat, cmat, init_state):
        return SSDScanFn.apply(x, dt, a, bmat, cmat, chunk, init_state)
    _check_card(x, dt, a, bmat, cmat, init_state)
    return torch.ops.repro_torch.ssd_scan(x, dt, a, bmat, cmat, init_state, int(chunk))


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cuda")
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                 cmat: torch.Tensor, init_state: torch.Tensor | None,
                 chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return ssd_scan_raw(x, dt, a, bmat, cmat, init_state)


@_ssd_scan_op.register_fake
def _(x, dt, a, bmat, cmat, init_state, chunk):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, p, bmat.shape[3]), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, init_shape, chunk, *,
                    out_shape=None, **_) -> int:
    from .registry import _ssd_cost

    b, s, h, p = x_shape
    return _ssd_cost(b=b, s=s, h=h, g=b_shape[2], p=p, n=b_shape[3], chunk=chunk)["flops"]


def ssd_scan_raw(x, dt, a, bmat, cmat, init_state=None):
    """The raw K8 launch on CUDA tensors as ``ssd_scan`` checks them (the
    custom op's implementation): the route by dtype, (y, final state);
    counts ``ssd_scan.launches`` and ``ssd_scan.route_launches``."""
    _check_aligned(x, bmat, cmat)
    design = route(x)
    y, state, launched = _launch(design, x, dt, a, bmat, cmat, init_state)
    ssd_scan.launches += launched
    ssd_scan.route_launches[design] += launched
    return y, state


def ssd_scan_scalar(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                    cmat: torch.Tensor, chunk: int = 128,
                    init_state: torch.Tensor | None = None):
    """K8's first design (f32 pipe, one block per (batch, head)) on any input
    ``ssd_scan`` takes; the plain version on a CPU tensor."""
    _check(x, dt, a, bmat, cmat, init_state)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, init_state=init_state)
    _check_card(x, dt, a, bmat, cmat, init_state)
    _check_aligned(x, bmat, cmat)
    y, state, launched = _launch("scalar", x, dt, a, bmat, cmat, init_state)
    ssd_scan_scalar.launches += launched
    return y, state


ssd_scan.launches = 0
ssd_scan.route_launches = {"mma": 0, "scalar": 0}
ssd_scan_scalar.launches = 0


class SSDScanFn(torch.autograd.Function):
    """K8 under autograd: ``apply(x, dt, a, bmat, cmat, chunk, init_state)`` ->
    (y, final state).

    The forward runs ``ssd_scan``; the backward differentiates
    ``ssd_scan_plain`` at ``chunk``, recomputed on the saved inputs.  Either
    output's cotangent may be absent (a training forward drops the state).
    """

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk=128, init_state=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat, init_state)
        ctx.chunk = chunk
        return ssd_scan(x, dt, a, bmat, cmat, chunk=chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        needs = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:7]
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wrt = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            outs = ssd_scan_plain(*inputs[:5], chunk=ctx.chunk, init_state=inputs[5])
        pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_state)) if g is not None]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs]))
        got = [next(grads) if t is not None and t.requires_grad else None for t in inputs]
        return (*got[:5], None, got[5])
