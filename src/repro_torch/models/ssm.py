"""Mamba-2 SSD (state-space duality) block (arXiv:2405.21060).

Counterpart of ``repro/models/ssm.py``.  Prefill runs the chunked SSD scan
through kernel K8 (``kernels.ssd_scan``) where the reference runs its XLA
``ssd_chunked`` (whose deployment counterpart is the Pallas ``ssd_scan``);
``impl="plain"`` runs K8's plain version, the same chunked algebra in torch.
Training runs K8 as ``SSDScanFn``, which ``ssd_scan`` picks itself where a
gradient is wanted: its backward is the autodiff of the plain version, as
the reference differentiates its XLA path.
Decode is the O(1) recurrent update carrying (conv window, SSD state), in
plain torch as the reference's is in jnp.

The dtype steps are the reference's: in_proj in the working dtype; the
causal conv summed in f32 and cast back (prefill), or summed and activated
in f32 and then cast (decode); dt's softplus in f32; the scan in f32 with y
cast back to the working dtype; then the ``d_skip`` term, the gated rmsnorm
and out_proj.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.ssd_scan import ssd_scan, ssd_scan_plain
from .layers import rmsnorm
from .sharding import local_call
from .spec import ParamSpec

__all__ = [
    "mamba_spec",
    "mamba_apply",
    "mamba_decode",
    "mamba_dims",
    "ssd_chunked",
]


def mamba_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return {
        "d_inner": d_inner,
        "n_heads": n_heads,
        "conv_dim": conv_dim,
        "d_in_proj": 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads,
    }


def mamba_spec(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    dims = mamba_dims(cfg)
    return {
        "in_proj": ParamSpec((cfg.d_model, dims["d_in_proj"]), ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.d_conv, dims["conv_dim"]), (None, "ssm_inner"), scale=1.0),
        "conv_b": ParamSpec((dims["conv_dim"],), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((dims["n_heads"],), (None,), init="ones"),
        "dt_bias": ParamSpec((dims["n_heads"],), (None,), init="zeros"),
        "d_skip": ParamSpec((dims["n_heads"],), (None,), init="ones"),
        "norm": ParamSpec((dims["d_inner"],), ("ssm_inner",), init="ones"),
        "out_proj": ParamSpec((dims["d_inner"], cfg.d_model), ("ssm_inner", "embed")),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, window d_conv.  xbc: (B, S, C); w: (K, C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc, dtype=torch.float32)
    for i in range(k):  # tiny static K (4): unrolled adds, as the reference
        out = out + pad[:, i:i + s].to(torch.float32) * w[i]
    return (out + b).to(xbc.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int, init_state: torch.Tensor | None = None,
                impl: str = "kernel"):
    """(y (B, S, H, P), final state (B, H, P, N) f32): K8, or its plain version.

    A ragged S is padded (plain) or masked (K8) as dt = 0, x = 0.  ``ssd_scan``
    takes ``SSDScanFn`` itself where a gradient is wanted.
    """
    fn = ssd_scan if impl == "kernel" else ssd_scan_plain
    # under a sharded step each rank scans its local batch rows and heads; B
    # and C keep a head shard only as groups (one group: replicated)
    grp = (0, 2) if bmat.shape[2] > 1 else (0, None)

    def scan(x, dt, a, bmat, cmat, init_state):
        return fn(x, dt, a, bmat, cmat, chunk=chunk, init_state=init_state)

    return local_call(scan, [x, dt, a, bmat, cmat, init_state],
                      [(0, 2), (0, 2), (None, 0), grp, grp, (0, 1)], [(0, 2), (0, 1)])


def _split(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """in_proj output -> (z, pre-activation xBC, raw dt)."""
    dims = mamba_dims(cfg)
    di, cd = dims["d_inner"], dims["conv_dim"]
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _heads(xbc: torch.Tensor, cfg: ModelConfig):
    """Activated xBC (..., conv_dim) -> views x (..., H, P), B and C (..., G, N)."""
    s = cfg.ssm
    dims = mamba_dims(cfg)
    di, h = dims["d_inner"], dims["n_heads"]
    gn = s.n_groups * s.d_state
    lead = xbc.shape[:-1]
    return (xbc[..., :di].reshape(*lead, h, s.head_dim),
            xbc[..., di:di + gn].reshape(*lead, s.n_groups, s.d_state),
            xbc[..., di + gn:].reshape(*lead, s.n_groups, s.d_state))


def _dt_a(dt_raw: torch.Tensor, p: dict):
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, -torch.exp(p["a_log"].to(torch.float32))


def mamba_apply(p: dict, xin: torch.Tensor, cfg: ModelConfig, *, impl: str = "kernel",
                init_state: torch.Tensor | None = None):
    """Full-sequence forward: (out (B, S, d), (conv_tail, ssd_state)) for the cache.

    ``conv_tail`` holds the last ``d_conv - 1`` *pre-activation* conv inputs
    (zeros before the sequence's start); ``ssd_state`` is the scan's final
    state in f32.  ``impl`` is the ``ssd_scan`` menu: ``"kernel"`` (K8) or
    ``"plain"``.
    """
    s = cfg.ssm
    b, sl = xin.shape[:2]
    zxbcdt = xin @ p["in_proj"]
    z, xbc_raw, dt_raw = _split(zxbcdt, cfg)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs, bmat, cmat = _heads(xbc, cfg)
    dt, a = _dt_a(dt_raw, p)
    y, state = ssd_chunked(xs, dt, a, bmat, cmat, s.chunk, init_state=init_state, impl=impl)
    y = y + xs * p["d_skip"].to(xs.dtype)[None, None, :, None]
    y = rmsnorm(y.reshape(b, sl, -1) * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    k1 = s.d_conv - 1
    conv_tail = F.pad(xbc_raw, (0, 0, max(0, k1 - sl), 0))[:, -k1:]
    return out, (conv_tail, state)


def mamba_decode(p: dict, xin: torch.Tensor, cfg: ModelConfig, conv_state: torch.Tensor,
                 ssd_state: torch.Tensor):
    """O(1) single-token step: xin (B, 1, d), conv_state (B, d_conv - 1, conv_dim),
    ssd_state (B, H, P, N) -> (out (B, 1, d), (new conv_state, new ssd_state))."""
    f32 = torch.float32
    zxbcdt = xin[:, 0] @ p["in_proj"]                              # (B, d_in_proj)
    z, xbc_new, dt_raw = _split(zxbcdt, cfg)
    window = torch.cat([conv_state, xbc_new[:, None]], dim=1)      # (B, d_conv, conv_dim)
    conv = (window.to(f32) * p["conv_w"][None].to(f32)).sum(1)
    xbc = F.silu(conv + p["conv_b"].to(f32)).to(xin.dtype)
    xs, bmat, cmat = _heads(xbc, cfg)
    rep = xs.shape[1] // bmat.shape[1]
    bh = bmat.repeat_interleave(rep, dim=1).to(f32)                # (B, H, N)
    ch = cmat.repeat_interleave(rep, dim=1).to(f32)
    dt, a = _dt_a(dt_raw, p)
    xf = xs.to(f32)
    new_state = (ssd_state * torch.exp(dt * a)[:, :, None, None]
                 + (dt[:, :, None] * xf)[..., None] * bh[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", ch, new_state)
    y = y + xf * p["d_skip"].to(f32)[None, :, None]
    y = y.reshape(xs.shape[0], -1).to(xin.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return (y @ p["out_proj"])[:, None], (window[:, 1:], new_state)
