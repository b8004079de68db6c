"""AxO deployment: run LM linear layers on a DSE-selected approximate operator.

Counterpart of ``repro/axo/deploy.py``.  The bridge from the paper's DSE
output (a LUT config) to the serving path:

  1. ``AxOOperator.from_config``: behavioral-model product table -> error table
     ``E = T - ab`` -> rank-R SVD factors ``(f, g)`` + the signed-value table
     (numpy, as the reference).
  2. ``axo_linear``: per-tensor symmetric int8 quantization of activations and
     weights, then the AxO matmul -- kernel K6 (``kernels.axo_matmul``) or its
     plain version -- and dequantization.
  3. ``deploy_axo``: walk a model's parameter tree and build an
     :class:`AxODeployment` -- per-layer **cached** weight codes and scales for
     every attention q/k/v/o, MLP and MoE expert projection (plus the LM
     head), so decode steps never requantize weights per token.

The reference caches each weight's signed values and pre-gathered right
factors in f32, ``(1 + R)`` floats per weight: 91 GB for granite-3-2b's
2.53 G linear weights at R=8, more than the card holds.  The port caches the
uint8 codes (2.53 GB there) and K6 gathers values and factors from the
``(2^n, R)`` tables itself, which computes what the reference's
``ops.axo_matmul`` computes from codes.

K6's K splits resolve through the kernel registry under the context's
``tuning`` policy (``kernels.tuning.tiles_for``; ``axo_matmul.plan``'s
choice untuned).  A deployment resolves them once per shape, at its first
call: a decode step issues hundreds of K6 launches, and the resolution and
the reference's counter ``dispatch.axo_apply.<impl>`` fall there, never on a
launch (``axo_linear``, off the serving path, resolves and counts
``dispatch.axo_linear.<impl>`` a call).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.operator_model import error_tables, exact_product_table, product_tables, spec_for
from ..kernels.axo_matmul import axo_matmul, axo_matmul_plain
from ..kernels.tuning import launch_overrides
from ..obs import telemetry as obs

__all__ = [
    "AxOOperator",
    "AxODeployment",
    "AXO_LAYERS",
    "quantize_tensor",
    "quantize_weight",
    "axo_linear",
    "deploy_axo",
]


@dataclass(frozen=True)
class AxOOperator:
    """A deployable approximate multiplier: rank-R factorized error tables."""

    n_bits: int
    rank: int
    f_table: np.ndarray          # (2^n, R) float32
    g_table: np.ndarray          # (2^n, R) float32
    signed_vals: np.ndarray      # (2^n,) int32
    table: np.ndarray            # (2^n, 2^n) int32 exact approximate products

    @staticmethod
    def from_config(config: np.ndarray, rank: int = 8, n_bits: int = 8) -> "AxOOperator":
        spec = spec_for(n_bits)
        table = product_tables(spec, np.asarray(config)[None])[0]
        err = error_tables(spec, np.asarray(config)[None])[0].astype(np.float64)
        u, s, vt = np.linalg.svd(err)
        r = min(rank, len(s))
        f = (u[:, :r] * s[:r]).astype(np.float32)
        g = vt[:r].T.astype(np.float32)
        return AxOOperator(
            n_bits=n_bits, rank=r, f_table=f, g_table=g,
            signed_vals=spec.operand_values.astype(np.int32), table=table,
        )

    # -- quality of the rank knob --------------------------------------------

    def rank_table(self) -> np.ndarray:
        """Rank-R reconstruction of the product table (float)."""
        exact = exact_product_table(self.n_bits).astype(np.float64)
        return exact + self.f_table.astype(np.float64) @ self.g_table.astype(np.float64).T

    def rank_behav(self) -> dict:
        """BEHAV metrics of the rank-R approximation vs the TRUE operator table
        (how much fidelity the factorization itself costs)."""
        t_true = self.table.astype(np.float64)
        t_rank = self.rank_table()
        d = np.abs(t_rank - t_true)
        exact = np.maximum(np.abs(exact_product_table(self.n_bits)), 1).astype(np.float64)
        return {
            "AVG_ABS_ERR": float(d.mean()),
            "AVG_ABS_REL_ERR": float(100.0 * (d / exact).mean()),
            "MAX_ABS_ERR": float(d.max()),
        }


def _scale(amax: torch.Tensor, n_bits: int) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / ((1 << (n_bits - 1)) - 1)


def _codes(x: torch.Tensor, scale: torch.Tensor, n_bits: int) -> torch.Tensor:
    qmax = (1 << (n_bits - 1)) - 1
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int32)
    return q & ((1 << n_bits) - 1)


def quantize_tensor(x: torch.Tensor, n_bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8-style quantization -> (int32 codes, 0-dim scale).

    One scale over the whole tensor (a prefill's every row included); codes
    are rounded half to even and masked into table-index (two's complement)
    space, as the reference's.
    """
    scale = _scale(x.abs().max(), n_bits)
    return _codes(x, scale, n_bits), scale


#: elements of a weight quantized at once: the f32 scratch of :func:`quantize_weight`
QUANT_BLOCK = 1 << 26


def quantize_weight(w: torch.Tensor, n_bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_tensor`` of a (K, N) weight's f32 copy as (uint8 codes, scale),
    bit for bit, computed over row blocks of at most ``QUANT_BLOCK`` elements: the
    largest magnitude first, then each block's codes.  A whole (7168, 163840)
    head would need ~19 GB of f32 and int32 scratch at once."""
    rows = max(1, QUANT_BLOCK // max(w.shape[-1], 1))
    blocks = range(0, w.shape[0], rows)
    amax = torch.stack([w[i:i + rows].abs().max().to(torch.float32) for i in blocks]).max()
    scale = _scale(amax, n_bits)
    codes = torch.empty(w.shape, dtype=torch.uint8, device=w.device)
    for i in blocks:
        codes[i:i + rows] = _codes(w[i:i + rows].to(torch.float32), scale, n_bits)
    return codes, scale


def _tables(op: AxOOperator, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The operator's (f, g, signed values) tables as f32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.asarray(t, np.float32)).to(device).contiguous()
                 for t in (op.f_table, op.g_table, op.signed_vals))


def _impl(ctx, default: str) -> str:
    return default if ctx is None else ctx.resolve_impl("axo_matmul", default)


def _k6_tiles(ctx, site: str, impl: str, m: int, k: int, n: int, rank: int) -> dict:
    """K6's tuned launch tiles at one shape (``{}`` untuned); counts
    ``dispatch.<site>.<impl>``."""
    obs.of(ctx).count(f"dispatch.{site}.{impl}")
    if impl != "kernel":
        return {}
    return launch_overrides(ctx, "axo_matmul.kernel", m=m, k=k, n=n, rank=rank)


def _matmul(impl: str, tiles: dict, a_codes, b_codes, f, g, sv) -> torch.Tensor:
    """K6 at ``tiles`` or its plain version on uint8 codes."""
    if impl == "kernel":
        return axo_matmul(a_codes, b_codes, f, g, sv, **tiles)
    return axo_matmul_plain(a_codes, b_codes, f, g, sv)


def axo_linear(
    x: torch.Tensor,             # (..., K) float activations
    w: torch.Tensor,             # (K, N) float weights
    op: AxOOperator,
    use_kernel: bool = True,
    ctx=None,                    # optional core.engine.ExecutionContext
) -> torch.Tensor:
    """y = x @ w evaluated through the approximate operator's arithmetic.

    ``use_kernel`` picks K6 (``False`` its plain version, the reference's
    ``use_kernel=False`` contraction); ``ctx`` may override it through its
    ``axo_matmul`` menu and supplies tuned K splits.
    """
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w.shape[1]
    xq, sx = quantize_tensor(x.reshape(-1, k), op.n_bits)
    wq, sw = quantize_tensor(w, op.n_bits)
    f, g, sv = _tables(op, x.device)
    impl = _impl(ctx, "kernel" if use_kernel else "plain")
    tiles = _k6_tiles(ctx, "axo_linear", impl, xq.shape[0], k, n, op.rank)
    y = _matmul(impl, tiles, xq.to(torch.uint8), wq.to(torch.uint8).contiguous(), f, g, sv)
    return (y * (sx * sw)).reshape(*lead, n).to(x.dtype)


# ---------------------------------------------------------------------------
# Whole-model deployment
# ---------------------------------------------------------------------------

#: parts of the network ``deploy_axo`` can swap onto the approximate operator
AXO_LAYERS = ("attn", "mlp", "moe", "head")


@dataclass(frozen=True)
class AxODeployment:
    """DSE-selected operator deployed into every linear layer of a model.

    Weights are quantized ONCE at deploy time: each entry caches the weight's
    ``(K, N)`` uint8 codes and its f32 scale; a call only quantizes the
    activation.  Entries for stacked layers carry a leading ``repeats`` axis,
    as the parameters do.

    ``stages[str(si)][str(li)]`` mirrors ``params["stages"]`` with per-layer
    ``{"mixer": ..., "mlp": ...}`` entry dicts (a moe layer's ``"mlp"`` holds
    ``"experts"``, each bank's entry stacked over (repeats, experts), and
    ``"shared"``; an ``attn_x`` mixer's holds ``"self"`` and ``"cross"``);
    ``encoder`` mirrors the encoder stage, ``{"0": ...}``, where the model
    has one; ``head`` is a single ``(d, vocab)`` entry.  ``n_entries``
    counts entries as the reference does (one per stacked weight).  ``ctx`` picks K6 or its
    plain version and K6's tuned K splits (``dataclasses.replace(dep,
    ctx=...)`` shares the cached codes).
    """

    op: AxOOperator
    layers: tuple
    f_table: torch.Tensor                # (2^n, R) f32, device-resident
    g_table: torch.Tensor                # (2^n, R) f32
    signed_vals: torch.Tensor            # (2^n,) f32
    stages: dict = field(default_factory=dict)
    encoder: dict | None = None
    head: dict | None = None
    ctx: object | None = None            # ExecutionContext: the axo_matmul route
    n_entries: int = 0
    # K6's tiles by (M, K, N), resolved at a shape's first call
    _k6: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def impl(self) -> str:
        return _impl(self.ctx, "kernel")

    def apply(self, x: torch.Tensor, entry: dict) -> torch.Tensor:
        """x @ W through the approximate operator, W cached in ``entry``."""
        lead = x.shape[:-1]
        k = x.shape[-1]
        codes = entry["codes"]
        n = codes.shape[-1]
        xq, sx = quantize_tensor(x.reshape(-1, k).to(torch.float32), self.op.n_bits)
        shape = (xq.shape[0], k, n)
        tiles = self._k6.get(shape)
        if tiles is None:
            tiles = self._k6[shape] = _k6_tiles(self.ctx, "axo_apply", self.impl, *shape,
                                                self.op.rank)
        y = _matmul(self.impl, tiles, xq.to(torch.uint8), codes, self.f_table,
                    self.g_table, self.signed_vals)
        y = y * (sx * entry["scale"])
        return y.reshape(*lead, n).to(x.dtype)


def deploy_axo(
    params: dict,
    op: AxOOperator,
    cfg,
    *,
    layers: tuple = AXO_LAYERS,
    ctx=None,
) -> AxODeployment:
    """Build an :class:`AxODeployment` for ``params`` of a model ``cfg``.

    Walks ``cfg.stages`` (and the encoder stage) next to ``params`` and
    caches an entry for every deployable projection:

    * ``"attn"`` -- attention wq/wk/wv/wo (causal, the encoder's non-causal,
      both halves of ``attn_x``, the VLM's gated ``xattn``) and MLA's
      wq_a/wq_b/wkv_a/wo; MLA's ``wkv_b`` stays exact (its absorbed halves
      contract per head against latents, not as a (K, N) linear);
    * ``"mlp"``  -- dense FFN w_gate/w_up/w_down, and a MoE layer's shared
      expert;
    * ``"moe"``  -- the routed expert banks, one entry per (repeat, expert),
      each expert with its own scale; the router stays exact (it picks which
      experts run, a routing decision rather than arithmetic);
    * ``"head"`` -- the unembedding (tied: ``embed.T``), quantized once here.

    A mamba mixer gets no entries, as in the reference (whose ``deploy_axo``
    covers attention, MLA, dense and MoE layers only): its in_proj, conv and
    out_proj stay exact, so mamba2-130m deploys the head alone
    (``n_entries == 1``); a mamba layer's dense or moe MLP (jamba) gets its
    entries.

    Entries live on the parameters' device; each weight is quantized layer by
    layer, and an expert bank expert by expert, in f32, so the f32 copy of one
    layer's (or one expert's) weight is the only scratch: a whole kimi-k2
    bank, (384, 7168, 2048), would be 22.5 GB in f32.
    """
    unknown = set(layers) - set(AXO_LAYERS)
    if unknown:
        raise ValueError(f"unknown AxO layer groups {sorted(unknown)}; "
                         f"choose from {AXO_LAYERS}")
    device = params["norm_f"].device
    f_dev, g_dev, sv_dev = _tables(op, device)
    count = [0]

    def prep(w2d):
        """(K, N) weight -> cached codes/scale entry."""
        count[0] += 1
        codes, sw = quantize_weight(w2d, op.n_bits)
        return {"codes": codes, "scale": sw}

    def prep_r(w, tail2=None):
        """Stacked (repeats, [experts,] K, N) weight -> entry stacked over the
        leading axes, quantized one (K, N) matrix at a time."""
        if tail2 is not None:
            w = w.reshape(w.shape[0], *tail2)
        lead = w.shape[:-2]
        codes = torch.empty(w.shape, dtype=torch.uint8, device=device)
        scale = torch.empty(lead, dtype=torch.float32, device=device)
        for idx in np.ndindex(*lead):
            codes[idx], scale[idx] = quantize_weight(w[idx], op.n_bits)
        count[0] += 1
        return {"codes": codes, "scale": scale}

    def attn_entries(mp):
        _, d, h, hd = mp["wq"].shape
        g = mp["wk"].shape[2]
        return {
            "wq": prep_r(mp["wq"], (d, h * hd)),
            "wk": prep_r(mp["wk"], (d, g * hd)),
            "wv": prep_r(mp["wv"], (d, g * hd)),
            "wo": prep_r(mp["wo"], (h * hd, mp["wo"].shape[3])),
        }

    def mla_entries(mp):
        r_q, h, qd = mp["wq_b"].shape[1:]
        _, v_hd, d = mp["wo"].shape[1:]
        return {
            "wq_a": prep_r(mp["wq_a"]),
            "wq_b": prep_r(mp["wq_b"], (r_q, h * qd)),
            "wkv_a": prep_r(mp["wkv_a"]),
            "wo": prep_r(mp["wo"], (h * v_hd, d)),
        }

    def mlp_entries(mp):
        return {k: prep_r(mp[k]) for k in ("w_gate", "w_up", "w_down") if k in mp}

    def layer_entries(mixer, mlp, lp):
        ent = {}
        if "attn" in layers:
            if mixer in ("attn", "attn_nc", "xattn"):
                ent["mixer"] = attn_entries(lp["mixer"])
            elif mixer == "attn_x":
                ent["mixer"] = {"self": attn_entries(lp["mixer"]["self"]),
                                "cross": attn_entries(lp["mixer"]["cross"])}
            elif mixer == "mla":
                ent["mixer"] = mla_entries(lp["mixer"])
        if mlp == "dense" and "mlp" in layers:
            ent["mlp"] = mlp_entries(lp["mlp"])
        elif mlp == "moe":
            sub = {}
            if "mlp" in layers and "shared" in lp["mlp"]:
                sub["shared"] = mlp_entries(lp["mlp"]["shared"])
            if "moe" in layers:
                sub["experts"] = {k: prep_r(lp["mlp"][k]) for k in ("w_gate", "w_up", "w_down")}
            if sub:
                ent["mlp"] = sub
        return ent

    stages = {}
    for si, stage in enumerate(cfg.stages):
        sp = params["stages"][str(si)]
        stages[str(si)] = {
            str(li): layer_entries(mixer, mlp, sp[str(li)])
            for li, (mixer, mlp) in enumerate(stage.layers)
        }

    encoder = None
    if cfg.encoder is not None:
        encoder = {"0": layer_entries("attn_nc", "dense", params["encoder"]["stage"]["0"])}

    head = None
    if "head" in layers:
        w = (params["embed"]["tok"].T if cfg.tie_embeddings
             else params["embed"]["unembed"])
        head = prep(w)

    return AxODeployment(
        op=op, layers=tuple(layers), f_table=f_dev, g_table=g_dev, signed_vals=sv_dev,
        stages=stages, encoder=encoder, head=head, ctx=ctx, n_entries=count[0],
    )
