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
type.  bf16 takes one of three routes, which :func:`plan` picks from the
shape: ``"mma"`` (``mma.sync`` on 64 x 64 tiles, its softmax weights carried
as a bf16 hi + lo pair; the short causal prefills at hd 64 and below),
``"wgmma"`` (Hopper's warpgroup MMA, 64, 128 or 192 query rows of a head a
block against TMA-fed 128-key tiles, its weights rounded once to bf16 as the
TPU kernel rounds them; non-causal calls and causal ones over at least
``WGMMA_CAUSAL_KV`` keys, at head widths ``WGMMA_HEAD_DIMS``) and
``"stacked"`` (the same warpgroups and tiles, each taking one of a KV group's
heads at the same 64 query rows, so that one K/V tile serves 1 or 2 heads;
the short causal prefills at ``STACKED_HEAD_DIMS``, hd 112 in 128-wide tiles
whose last 16 columns TMA fills with zeros).
``tests/test_torch_kernel_design.py`` emulates them in plain torch.  The
f32 kernel keeps its weights in f32.  For bf16 every row of q, k, v and the
output must start on a 16-byte boundary: the kernels copy K/V rows in
16-byte pieces (TMA boxes on the wgmma routes), their launcher
refuses a view that breaks that, and the wrapper raises.  The kernel is
built for the head widths in ``HEAD_DIMS``: granite's 64, the reduced
configs' 16, internlm2's,
starcoder2's and deepseek-67b's 128, and kimi-k2's 112; another width raises.
On a CPU tensor the wrapper returns the plain version; on a CUDA tensor it
launches the kernel or raises.  ``flash_attention.launches`` counts kernel
launches, ``flash_attention.route_launches`` each route's.

Training takes K7 through :class:`FlashAttentionFn`, an autograd function:
its forward is ``flash_attention`` (K7 on the card, the plain version on a
CPU tensor) and its backward is :func:`blockwise_attention`'s: it recomputes
the blockwise forward on the saved q, k and v (no grad) for the output and
each row's log-sum-exp, then runs the blockwise backward, block pair by
block pair.  Nothing of size Sq x Skv is made, so a training step holds
O(B H S hd) for its attention, as the reference does: the reference trains
through its XLA ``chunked_attention`` (an online softmax over KV blocks, each
under ``jax.checkpoint``) and has no backward kernel.  It is not a fallback:
the forward never gives way to a plain version on the card.
``flash_attention`` takes that route itself where a gradient is wanted
(grad mode on and an input that requires grad, on a CUDA tensor): the
kernel's output carries no ``grad_fn``, so no caller may reach the raw
launch with such inputs, and none has to know the rule.
``FlashAttentionFn.forward`` runs with grad off and so reaches the launch.

:func:`blockwise_attention` is the reference's ``chunked_attention`` in
plain torch (an autograd function, :class:`BlockwiseAttentionFn`): inside
each block of ``q_chunk`` query rows an online softmax over blocks of
``kv_chunk`` keys, with an f32 running max, sum and accumulator (f64 for
f64 inputs); the queries are viewed in (group, rep) form, so K and V are
never repeated to the heads.  With ``causal`` a query block scans only
the KV blocks up to its last row's absolute position (``q_offset`` + row),
as the reference's ``q_start`` (``causal_block_skip``) does; the skipped
blocks would add exact zeros, so the output bits are those of a full scan,
and a Python loop gains nothing from scanning them.  It keeps
the reference's masking constant (-1e30, not -inf) and its ``acc /
max(l, 1e-30)``: a row with no valid key (``kv_len`` 0) gets the mean of
the values it scanned, where the direct plain version gives NaN.  The
value width may differ from the key width (MLA).  Its backward works a
block pair at a time (``D = rowsum(dO * O)``, ``P = exp(scale q k^T -
lse)``, ``dV += P^T dO``, ``dS = P * (dO v^T - D)``, ``dQ += scale dS k``,
``dK += scale dS^T q``, dK and dV summed over each group's heads) and saves
only q, k, v, the output and each row's log-sum-exp.  Where
``FlashAttentionFn`` runs it, nothing is saved but q, k and v: each query
block's output and log-sum-exp are recomputed just before its gradient
pass, and a block that scans one KV block keeps its scores for that pass
(the same bits as computing them again).  The model's prefill
and training attention runs it on the CPU and with ``impl="plain"``, and
MLA runs it everywhere at Sq > 4; ``flash_attention_plain`` stays K7's twin,
the one held against the kernel.

The first call at a (Sq, kv_len) and plan that the current telemetry sees
records its pad-to-tile waste over the route's (query, key) tiles there as
``flash_attention.pad_waste``: the raw launcher records the plan it launches,
the op's fake implementation the plan for an H100 (a traced step has no card
to ask), and the wrapper on a CPU tensor the same.  A launch plans once.

The card's entry is the custom op ``torch.ops.repro_torch.flash_attention``
(CUDA only), which ``flash_attention`` calls on a CUDA tensor and whose
implementation is the raw launcher, :func:`flash_attention_raw` (which also
takes a ``route``; the op leaves it to :func:`plan`).  The op
has a fake implementation (the output's shape, dtype, layout and device,
no launch), so a step traced on fake tensors (the dry-run,
``launch.lowering``) passes through it, and a FLOP formula, the registry's
``cost_fn`` (``kernels.registry``: 4 b h sq kv_len hd, halved when causal),
so ``torch.utils.flop_counter`` counts the kernel's own work where it would
count the plain version's (2x ``cost_fn`` causal: the plain version
computes every score and masks half).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ..obs.telemetry import current, record_pad_waste
from . import build

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_raw",
           "FlashAttentionFn", "blockwise_attention", "BlockwiseAttentionFn", "HEAD_DIMS",
           "plan", "Plan"]

HEAD_DIMS = (16, 32, 64, 112, 128)   # head widths the kernel is built for
TILE = 64                  # query rows and keys of the mma and f32 tiles (csrc kBQ, kBK)
WGMMA_HEAD_DIMS = (64, 128)   # head widths the wgmma route is built for
STACKED_HEAD_DIMS = (112, 128)   # head widths the head-stacked route is built for
WGMMA_ROWS = 64            # query rows of a consumer warpgroup (csrc kWgRows)
WGMMA_KEYS = 128           # keys of the wgmma route's K/V tiles (csrc kWgKeys)
# causal calls over at least this many keys take the wgmma route: on the H100
# the mma route is as fast or faster below (chip_smoke.py times both routes on
# granite's heads at 128, 256, 512 and 4,096 keys; PERF.md section 6)
WGMMA_CAUSAL_KV = 512
# query rows a wgmma block may own (one to three consumer warpgroups); three
# only at hd 64, where a thread's registers leave room for a third
WGMMA_BLOCK_ROWS = {64: (192, 128, 64), 128: (128, 64)}
# heads a head-stacked block holds at once (a consumer warpgroup each: 128
# registers of accumulator and scores a thread leave room for two) and rounds
# of them it may walk (the next round's q loaded during this one)
STACKED_HEADS = (1, 2)
STACKED_ROUNDS = (1, 2)
H100_SMS = 132             # plan()'s default; a launch passes its card's count
ROUTES = ("mma", "wgmma", "stacked", "f32")
_ROUTE_IDS = {"mma": 0, "f32": 0, "wgmma": 1, "stacked": 2}   # the launcher's route numbers
_STRIDES = ctypes.c_longlong * 12
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MISALIGNED = -1           # the launcher's answer to a bf16 row off a 16-byte boundary
_REFUSED = -2              # ... to a call the wgmma route does not take
NEG_INF = -1e30            # the reference's masking constant (blockwise_attention)
CHUNK = 1024               # the reference's default attention chunks (attn_q/kv_chunk)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, scale: float | None = None,
                          q_offset: int = 0, kv_len: int | None = None) -> torch.Tensor:
    """Plain version of K7: the direct masked softmax, (B, H, Sq, hd), in f32
    (f64 for f64 inputs)."""
    b, h, sq, hd = q.shape
    g, skv = k.shape[1], k.shape[2]
    rep = h // g
    scale = (1.0 / math.sqrt(hd)) if scale is None else scale
    kv_len = skv if kv_len is None else kv_len
    acc = torch.promote_types(q.dtype, torch.float32)
    kh = k.to(acc).repeat_interleave(rep, dim=1)
    vh = v.to(acc).repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), kh) * scale
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
        ctypes.c_float, i, i, i, i, i, i, p,
    ]
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           kv_len: int, value_width: bool = False) -> None:
    """Shapes, dtypes, devices and the offsets; ``value_width`` lets v's
    width differ from q's and k's."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H|G, S, hd)")
    b, h, _, hd = q.shape
    if (k.shape[:3] != v.shape[:3] or (k.shape[3] != v.shape[3] and not value_width)
            or k.shape[0] != b or k.shape[3] != hd):
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


class Plan(NamedTuple):
    route: str          # "mma" (bf16, mma.sync), "wgmma", "stacked" (bf16, wgmma) or "f32"
    rows: int           # query rows a block holds at once (stacked: 64 a head)
    keys: int           # keys of a K/V tile
    heads: int = 1      # heads a block walks (stacked: rows / 64 at once, in rounds)


def route_for(bf16: bool, hd: int, causal: bool, kv_len: int) -> str:
    """The route :func:`plan` takes: a pure function of the shape."""
    if not bf16:
        return "f32"
    if kv_len >= 1 and causal and kv_len < WGMMA_CAUSAL_KV and hd in STACKED_HEAD_DIMS:
        return "stacked"
    if hd in WGMMA_HEAD_DIMS and kv_len >= 1 and (not causal or kv_len >= WGMMA_CAUSAL_KV):
        return "wgmma"
    return "mma"


@functools.lru_cache(maxsize=4096)
def plan(b: int, h: int, sq: int, kv_len: int, hd: int, causal: bool, bf16: bool = True,
         n_sms: int = H100_SMS, route: str | None = None, groups: int | None = None) -> Plan:
    """K7's launch for q (b, h, sq, hd) over ``kv_len`` keys of ``groups``
    KV groups (None: one a head).

    :func:`route_for` picks the route unless ``route`` names one (the wgmma
    route only for bf16 at ``WGMMA_HEAD_DIMS``, the stacked one only for bf16
    at ``STACKED_HEAD_DIMS``, both at ``kv_len >= 1``; the mma route only for
    bf16, the f32 kernel only for f32).  A wgmma block holds the most query
    rows of ``WGMMA_BLOCK_ROWS`` (192 at hd 64, 128 at hd 128; 64 a consumer
    warpgroup) whose blocks still fill the ``n_sms`` SMs, else 64.  A
    stacked block holds 1 or 2 heads of a group at once (``rows`` = 64 a
    head) for 1 or 2 rounds (``heads`` in all, dividing the group's): the
    choice with the fewest waves of blocks times rounds, then the most
    rounds (the next round's q loads during this one), then the fewest heads
    at once (more blocks to spread the bytes).
    """
    route = route_for(bf16, hd, causal, kv_len) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"K7 has the routes {ROUTES}, got {route!r}")
    if (route == "f32") == bf16 or (route in ("wgmma", "stacked") and (
            hd not in (WGMMA_HEAD_DIMS if route == "wgmma" else STACKED_HEAD_DIMS)
            or kv_len < 1)):
        raise ValueError(f"K7's {route} route does not take {'bf16' if bf16 else 'f32'} "
                         f"at hd {hd}, kv_len {kv_len}")
    if route == "stacked":
        rep = h // groups if groups else 1
        tiles = b * h * -(-sq // WGMMA_ROWS)   # (64-row tile, head) pairs

        def cost(choice):
            at_once, rounds = choice
            return (-(-tiles // (at_once * rounds) // n_sms) * rounds, -rounds, at_once)
        at_once, rounds = min(((n, r) for n in STACKED_HEADS for r in STACKED_ROUNDS
                               if rep % (n * r) == 0), key=cost)
        return Plan(route, at_once * WGMMA_ROWS, WGMMA_KEYS, at_once * rounds)
    if route != "wgmma":
        return Plan(route, TILE, TILE)
    rows = next((r for r in WGMMA_BLOCK_ROWS[hd] if b * h * -(-sq // r) >= n_sms), WGMMA_ROWS)
    return Plan(route, rows, WGMMA_KEYS)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _record_pad(pl: Plan, sq: int, kv_len: int) -> None:
    """Pad waste of K7's (query, key) iteration space on the plan's tiles, once
    a shape and plan on the current telemetry."""
    if current().first(("flash_attention", sq, kv_len, pl)):
        rows = WGMMA_ROWS if pl.route == "stacked" else pl.rows
        record_pad_waste("flash_attention", (sq, kv_len),
                         (-(-sq // rows) * rows, -(-kv_len // pl.keys) * pl.keys))


def _record_plan(q: torch.Tensor, k: torch.Tensor, kv_len: int, causal: bool,
                 n_sms: int) -> None:
    """:func:`_record_pad` of the plan for ``q`` and ``k`` on ``n_sms`` SMs, where
    no launch makes one."""
    b, h, sq, hd = q.shape
    _record_pad(plan(b, h, sq, kv_len, hd, bool(causal), q.dtype == torch.bfloat16, n_sms,
                     None, k.shape[1]), sq, kv_len)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, kv_len: int | None = None, q_chunk: int = CHUNK,
                    kv_chunk: int = CHUNK) -> torch.Tensor:
    """K7: q (B, H, Sq, hd), k/v (B, G, Skv, hd) f32 or bf16 -> (B, H, Sq, hd).

    Where a gradient is wanted on a CUDA tensor it runs as
    :class:`FlashAttentionFn` (K7 forward, the blockwise backward over
    ``q_chunk`` x ``kv_chunk`` blocks); elsewhere the chunks are unused.
    """
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    _check(q, k, v, q_offset, kv_len)
    if q.device.type == "cpu":
        _record_plan(q, k, kv_len, causal, H100_SMS)
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, q_offset, kv_len, q_chunk,
                                      kv_chunk)
    hd = q.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"K7 takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"K7 is built for head_dim in {HEAD_DIMS}, got {hd}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous head dimension")
    scale = (1.0 / math.sqrt(hd)) if scale is None else float(scale)
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal), scale, q_offset,
                                                 kv_len)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        scale: float, q_offset: int, kv_len: int) -> torch.Tensor:
    return flash_attention_raw(q, k, v, causal, scale, q_offset, kv_len)


@_flash_attention_op.register_fake
def _(q, k, v, causal, scale, q_offset, kv_len):
    _record_plan(q, k, kv_len, causal, H100_SMS)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, scale, q_offset, kv_len, *,
                           out_shape=None, **_) -> int:
    from .registry import _flash_cost

    b, h, sq, hd = q_shape
    return _flash_cost(b=b, h=h, sq=sq, skv=kv_len, hd=hd, causal=causal)["flops"]


def flash_attention_raw(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                        scale: float, q_offset: int, kv_len: int,
                        route: str | None = None) -> torch.Tensor:
    """The raw K7 launch on CUDA tensors as ``flash_attention`` checks them
    (the custom op's implementation), on :func:`plan`'s route or the one
    ``route`` names; records the plan's pad waste and counts
    ``flash_attention.launches`` and ``flash_attention.route_launches``."""
    b, h, sq, hd = q.shape
    out = torch.empty_like(q)   # q's layout: dense with a contiguous head dim
    if out.numel() == 0:
        return out
    g = k.shape[1]
    pl = plan(b, h, sq, kv_len, hd, bool(causal), q.dtype == torch.bfloat16,
              _sm_count(q.device), route, g)
    _record_pad(pl, sq, kv_len)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    os_ = out.stride()
    strides = _STRIDES(qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
                       os_[0], os_[1], os_[2])
    # the current stream's raw handle (what current_stream().cuda_stream reads,
    # without making a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
        _DTYPES[q.dtype], b, h, g, sq, hd, scale, int(causal), q_offset,
        kv_len, _ROUTE_IDS[pl.route], pl.rows, pl.heads, stream,
    )
    if err == _MISALIGNED:
        raise ValueError("K7 in bf16 needs every row of q, k, v and out on a 16-byte "
                         "boundary: data at " + ", ".join(
                             f"{t.data_ptr():#x} strides {tuple(t.stride())}"
                             for t in (q, k, v, out)))
    if err == _REFUSED:
        raise RuntimeError(f"K7's {pl.route} route refused {pl} at q {tuple(q.shape)}, "
                           f"{g} KV groups, kv_len {kv_len} (a tensor map libcuda would not "
                           f"make, or a block's heads across two KV groups)")
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    flash_attention.route_launches[pl.route] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


class FlashAttentionFn(torch.autograd.Function):
    """K7 under autograd: ``apply(q, k, v, causal, scale, q_offset, kv_len,
    q_chunk=CHUNK, kv_chunk=CHUNK)``.

    The forward runs ``flash_attention``; the backward is
    :func:`blockwise_attention`'s over ``q_chunk`` x ``kv_chunk`` blocks,
    each query block's output and log-sum-exp recomputed on the saved q, k
    and v just before its gradient pass (module docstring), so the gradients
    equal ``BlockwiseAttentionFn``'s on the same inputs bit for bit.  q, k
    and v as ``flash_attention`` takes them, causal or not, at any Sq and Skv.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal=True, scale=None, q_offset=0, kv_len=None,
                q_chunk=CHUNK, kv_chunk=CHUNK):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len)
        ctx.blocks = dict(q_chunk=q_chunk, kv_chunk=kv_chunk)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        kw = _blockwise_args(q, k, **ctx.kw, **ctx.blocks)
        return (*_blockwise_backward(q, k, v, grad_out, **kw), *(None,) * 6)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale: float | None = None, q_offset: int = 0,
                        kv_len: int | None = None, q_chunk: int = CHUNK,
                        kv_chunk: int = CHUNK) -> torch.Tensor:
    """The reference's ``chunked_attention`` in plain torch (module
    docstring): q (B, H, Sq, hd), k (B, G, Skv, hd), v (B, G, Skv, hd_v) ->
    (B, H, Sq, hd_v) in q's dtype, laid out as (B, Sq, H, hd_v) in memory (as
    K7's output of the model's views).  Differentiable, with a backward
    that holds O(B H S hd)."""
    kv_len = k.shape[2] if kv_len is None else int(kv_len)
    _check(q, k, v, int(q_offset), kv_len, value_width=True)
    if q_chunk < 1 or kv_chunk < 1:
        raise ValueError(f"chunks must be positive, got q {q_chunk}, kv {kv_chunk}")
    return BlockwiseAttentionFn.apply(q, k, v, causal, scale, q_offset, kv_len, q_chunk,
                                      kv_chunk)


class BlockwiseAttentionFn(torch.autograd.Function):
    """:func:`blockwise_attention` under autograd: ``apply(q, k, v, causal,
    scale, q_offset, kv_len, q_chunk, kv_chunk)``; saves q, k, v, the output
    and each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_len, q_chunk, kv_chunk):
        kw = _blockwise_args(q, k, causal=causal, scale=scale, q_offset=q_offset,
                             kv_len=kv_len, q_chunk=q_chunk, kv_chunk=kv_chunk)
        out, lse = _blockwise_forward(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_blockwise_backward(q, k, v, grad_out, out, lse, **ctx.kw), *(None,) * 6)


def _blockwise_args(q, k, *, causal, scale, q_offset, kv_len, q_chunk, kv_chunk) -> dict:
    """The blockwise passes' keywords with the defaults resolved."""
    return dict(causal=bool(causal), q_offset=int(q_offset), q_chunk=int(q_chunk),
                kv_chunk=int(kv_chunk),
                scale=(1.0 / math.sqrt(q.shape[3])) if scale is None else float(scale),
                kv_len=k.shape[2] if kv_len is None else int(kv_len))


def _kv_blocks(i1: int, skv: int, *, causal: bool, q_offset: int,
               kv_chunk: int) -> list[tuple[int, int]]:
    """The KV blocks [j0, j1) that query rows up to ``i1`` scan: with
    ``causal`` those up to the last row's absolute position (at least one,
    as the reference's ``n_need``), else all of them."""
    end = skv
    if causal:
        end = min(skv, max(1, (q_offset + i1 - 1) // kv_chunk + 1) * kv_chunk)
    return [(j, min(j + kv_chunk, skv)) for j in range(0, end, kv_chunk)]


class _Block:
    """One query block [i0, i1) of a blockwise pass: its rows of each
    group's ``rep`` heads as one (B G, rep (i1 - i0), hd) matrix in the
    compute dtype, and its scores against a KV block."""

    def __init__(self, q, k, i0, i1, *, causal, scale, q_offset, kv_len, **_):
        b, h, _, hd = q.shape
        self.b, self.g, self.rep, self.n = b, k.shape[1], h // k.shape[1], i1 - i0
        self.i0, self.i1, self.acc = i0, i1, torch.promote_types(q.dtype, torch.float32)
        self.causal, self.scale, self.q_offset, self.kv_len = causal, scale, q_offset, kv_len
        self.q = self.rows(q, hd)

    def rows(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x's (B, H, i0:i1, width) rows as (B G, rep n, width), compute dtype."""
        part = x.reshape(self.b, self.g, self.rep, x.shape[2], width)[:, :, :, self.i0:self.i1]
        return part.to(self.acc, memory_format=torch.contiguous_format).reshape(
            self.b * self.g, self.rep * self.n, width)

    def kv(self, x: torch.Tensor, j0: int, j1: int) -> torch.Tensor:
        """x's (B, G, j0:j1, width) block as (B G, j1 - j0, width), compute dtype."""
        return x[:, :, j0:j1].to(self.acc, memory_format=torch.contiguous_format).reshape(
            self.b * self.g, j1 - j0, x.shape[3])

    def masked(self, j0: int, j1: int) -> torch.Tensor | None:
        """The (n, j1 - j0) mask of the invalid (query, key) pairs, True where
        masked; None where every pair is valid."""
        qpos = self.q_offset + self.i0
        if j1 <= self.kv_len and (not self.causal or j1 - 1 <= qpos):
            return None
        shape = (self.n, j1 - j0)
        if self.causal:   # key j0 + c is past query qpos + r where c - r > qpos - j0
            masked = torch.ones(shape, dtype=torch.bool, device=self.q.device).triu_(
                qpos - j0 + 1)
        else:
            masked = torch.zeros(shape, dtype=torch.bool, device=self.q.device)
        if j1 > self.kv_len:
            masked[:, max(self.kv_len - j0, 0):] = True
        return masked

    def scores(self, kj: torch.Tensor, masked) -> torch.Tensor:
        """scale q k^T, the masked pairs at the reference's -1e30."""
        s = torch.baddbmm(self.q.new_empty(()), self.q, kj.transpose(1, 2), beta=0,
                          alpha=self.scale)
        if masked is not None:
            s.view(self.b, self.g, self.rep, self.n, -1).masked_fill_(masked, NEG_INF)
        return s

    def forward(self, k, v, blocks, keep: bool = False):
        """(out, lse[, s]): the block's output (B G, rep n, hd_v) and each
        row's log-sum-exp (B G, rep n), in the compute dtype, by an online
        softmax over ``blocks``; with ``keep`` also the masked scores of a
        block that scans one KV block (else None).  The first KV block
        starts the running max, sum and accumulator, which the reference's
        rescaling of its -1e30 / 0 carry gives exactly."""
        s_kept = None
        for n, (j0, j1) in enumerate(blocks):
            s = self.scores(self.kv(k, j0, j1), self.masked(j0, j1))
            vj = self.kv(v, j0, j1)
            if n == 0:
                m = s.amax(-1).clamp_(min=NEG_INF)
                s_kept = s if keep and len(blocks) == 1 else None
                p = (s - m[..., None] if keep else s.sub_(m[..., None])).exp_()
                l = p.sum(-1)
                a = torch.bmm(_as_value(p, v.dtype), vj)
            else:
                m_new = torch.maximum(m, s.amax(-1))
                p = s.sub_(m_new[..., None]).exp_()
                alpha = torch.exp(m - m_new)
                l = l.mul_(alpha).add_(p.sum(-1))
                a = a.mul_(alpha[..., None]).add_(torch.bmm(_as_value(p, v.dtype), vj))
                m = m_new
            del s, p
        l = l.clamp_(min=1e-30)
        return a.div_(l[..., None]), m.add_(l.log_()), s_kept

    def put(self, dst: torch.Tensor, x: torch.Tensor) -> None:
        """Write (B G, rep n, ...) rows into dst's (B, H, i0:i1, ...) rows."""
        dst[:, :, self.i0:self.i1] = x.reshape(self.b, self.g * self.rep, self.n,
                                               *x.shape[2:])


def _as_value(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Softmax weights rounded to the value type, as the reference's
    ``p.astype(vh.dtype)`` (in the compute dtype again)."""
    return p if dtype == p.dtype else p.to(dtype).to(p.dtype)


def _blockwise_forward(q, k, v, *, q_chunk, kv_chunk, **kw):
    """(out, lse): the output (B, H, Sq, hd_v) in q's dtype, laid out as
    (B, Sq, H, hd_v), and each row's log-sum-exp (B, H, Sq) in the compute
    dtype (f32; f64 for f64 inputs)."""
    b, h, sq, _ = q.shape
    out = q.new_empty((b, sq, h, v.shape[3])).transpose(1, 2)
    lse = q.new_empty((b, h, sq), dtype=torch.promote_types(q.dtype, torch.float32))
    for i0 in range(0, sq, q_chunk):
        blk = _Block(q, k, i0, min(i0 + q_chunk, sq), **kw)
        blocks = _kv_blocks(blk.i1, k.shape[2], causal=blk.causal, q_offset=blk.q_offset,
                            kv_chunk=kv_chunk)
        o, l, _ = blk.forward(k, v, blocks)
        blk.put(out, o)
        blk.put(lse, l)
    return out, lse


def _blockwise_backward(q, k, v, dout, out=None, lse=None, *, q_chunk, kv_chunk, **kw):
    """(dq, dk, dv) in q's, k's and v's dtypes, a block pair at a time
    (module docstring), from the saved output and log-sum-exp or, where they
    are None, from each query block's own recomputed just before its
    gradient pass (the block's scores reused where it scans one KV block).
    The products over a group's (rep n) query rows sum dK and dV over its
    heads."""
    b, h, sq, hd = q.shape
    skv, hdv = k.shape[2], v.shape[3]
    acc = torch.promote_types(q.dtype, torch.float32)
    dq = q.new_empty((b, sq, h, hd)).transpose(1, 2)
    dk = k.new_zeros((b, k.shape[1], skv, hd), dtype=acc)
    dv = v.new_zeros((b, k.shape[1], skv, hdv), dtype=acc)
    for i0 in range(0, sq, q_chunk):
        blk = _Block(q, k, i0, min(i0 + q_chunk, sq), **kw)
        blocks = _kv_blocks(blk.i1, skv, causal=blk.causal, q_offset=blk.q_offset,
                            kv_chunk=kv_chunk)
        doi = blk.rows(dout, hdv)
        if lse is None:   # the output rounded to q's dtype, as the forward returns it
            oi, li, s_kept = blk.forward(k, v, blocks, keep=True)
            oi = oi.to(q.dtype).to(acc)
        else:
            oi, li, s_kept = blk.rows(out, hdv), blk.rows(lse[..., None], 1)[..., 0], None
        di = (doi * oi).sum(-1, keepdim=True)
        li = li[..., None]
        dqi = None
        for j0, j1 in blocks:
            kj, vj = blk.kv(k, j0, j1), blk.kv(v, j0, j1)
            masked = blk.masked(j0, j1)
            s = s_kept if s_kept is not None else blk.scores(kj, masked)
            p = s.sub_(li).exp_()
            dv[:, :, j0:j1] += torch.bmm(_as_value(p, v.dtype).transpose(1, 2),
                                         doi).view(b, -1, j1 - j0, hdv)
            ds = torch.bmm(doi, vj.transpose(1, 2)).sub_(di).mul_(p)
            if masked is not None and blk.kv_len == 0:   # rows with no valid key
                ds.view(b, blk.g, blk.rep, blk.n, -1).masked_fill_(masked, 0.0)
            dqi = torch.bmm(ds, kj) if dqi is None else dqi.add_(torch.bmm(ds, kj))
            dk[:, :, j0:j1] += torch.bmm(ds.transpose(1, 2), blk.q).view(b, -1, j1 - j0, hd)
            del s, p, ds
            s_kept = None
        blk.put(dq, dqi.mul_(blk.scale))
    return dq, dk.mul_(kw["scale"]).to(k.dtype), dv.to(v.dtype)
