"""Beyond-paper application: a transformer FFN block on AxO arithmetic.

The DSE target the paper never tried: both GEMMs of a GeLU FFN
(``W2 @ gelu(W1 @ x)``) run through the approximate operator's product table.
BEHAV = 100 x relative L2 error of the block output vs. the accurate-operator
int8 pipeline.  This is the bridge to the framework's LM serving path: configs
selected here are exactly what the AxO deployment puts inside the LM architectures.

Counterpart of ``repro/apps/ffn.py``; the data generators are the same code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.operator_model import exact_product_table
from .base import AxOApplication, quantize_int8, table_matmul
from .fastapp import _as_batch, table_matmul_torch

__all__ = ["TransformerFFN"]


def _gelu(x: np.ndarray) -> np.ndarray:
    # x*x*x, not x**3: np.power's generic pow is ~17x slower and this runs on
    # every hidden activation of every table evaluated by the BEHAV loop.
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * (x * x * x))))


def _gelu_requant_torch(h_int: torch.Tensor, scale: float, n_bits: int):
    """float32 GeLU + per-config symmetric quantizer on the device.

    Mirrors ``_gelu`` + ``quantize_int8`` for a (D, T, F) batch of GEMM1
    integer outputs: returns masked int32 codes and the (D,) f32 scales.
    ``torch.round`` rounds half to even, as ``np.round`` does.
    """
    f32 = torch.float32
    h = h_int.to(f32) * torch.tensor(scale, dtype=f32, device=h_int.device)
    c = torch.tensor(np.sqrt(2.0 / np.pi), dtype=f32, device=h_int.device)
    h = 0.5 * h * (1.0 + torch.tanh(c * (h + 0.044715 * (h * h * h))))
    qmax = (1 << (n_bits - 1)) - 1
    amax = h.abs().amax(dim=(1, 2))
    sh = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(h / sh[:, None, None]), -qmax - 1, qmax).to(torch.int32)
    return q & ((1 << n_bits) - 1), sh


@dataclass
class TransformerFFN(AxOApplication):
    name: str = "ffn"
    d_model: int = 64
    d_ff: int = 128
    n_tokens: int = 96
    seed: int = 17
    # "host": GeLU + per-config requantization in host float64, bit-identical
    # to the numpy oracle.  "device": the whole GEMM1 -> GeLU -> requant ->
    # GEMM2 chain stays on the device in float32 -- no (D, T, F) host round
    # trip between the GEMMs.  Device float32 rounds a handful of hidden codes
    # differently near .5 rounding boundaries, so BEHAV agrees to a stated
    # tolerance (see ``behav_torch_from_tables``), not bitwise.
    requant: str = "host"

    _x: np.ndarray = field(init=False, repr=False)
    _w1: np.ndarray = field(init=False, repr=False)
    _w2: np.ndarray = field(init=False, repr=False)
    _x_codes: np.ndarray = field(init=False, repr=False)    # (T, D)
    _w1_codes: np.ndarray = field(init=False, repr=False)   # (D, F)
    _w2_codes: np.ndarray = field(init=False, repr=False)   # (F, D)
    _sx: float = field(init=False, repr=False)
    _s1: float = field(init=False, repr=False)
    _s2: float = field(init=False, repr=False)
    _ref_out: np.ndarray | None = field(init=False, repr=False, default=None)
    _prep_bits: int = field(init=False, repr=False, default=0)

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._x = rng.standard_normal((self.n_tokens, self.d_model))
        self._w1 = rng.standard_normal((self.d_model, self.d_ff)) / np.sqrt(self.d_model)
        self._w2 = rng.standard_normal((self.d_ff, self.d_model)) / np.sqrt(self.d_ff)
        self._prepare(8)

    def _prepare(self, n_bits: int) -> None:
        if self._prep_bits == n_bits:
            return
        self._x_codes, self._sx = quantize_int8(self._x, n_bits=n_bits)
        self._w1_codes, self._s1 = quantize_int8(self._w1, n_bits=n_bits)
        self._w2_codes, self._s2 = quantize_int8(self._w2, n_bits=n_bits)
        self._ref_out = None
        self._prep_bits = n_bits

    def _forward(self, table: np.ndarray) -> np.ndarray:
        n_bits = self._prep_bits
        h = table_matmul(table, self._x_codes, self._w1_codes).astype(np.float64)
        h = _gelu(h * (self._sx * self._s1))
        h_codes, sh = quantize_int8(h, n_bits=n_bits)
        y = table_matmul(table, h_codes, self._w2_codes).astype(np.float64)
        return y * (sh * self._s2)

    def _ensure_reference(self) -> None:
        if self._ref_out is None:
            self._ref_out = self._forward(exact_product_table(self._prep_bits))

    def behav_from_tables(self, tables: np.ndarray) -> np.ndarray:
        tables = np.asarray(tables)
        if tables.ndim == 2:
            tables = tables[None]
        self._prepare(int(tables.shape[-1]).bit_length() - 1)
        self._ensure_reference()
        ref = self._ref_out
        denom = float(np.linalg.norm(ref)) or 1.0
        out = np.empty(len(tables), dtype=np.float64)
        for d, tab in enumerate(tables):
            out[d] = 100.0 * float(np.linalg.norm(self._forward(tab) - ref)) / denom
        return out

    def behav_torch_from_tables(self, tables) -> np.ndarray:
        """Both GEMMs on the device; GeLU + per-config requantization per ``requant``.

        ``requant="host"`` (default): the hidden quantization scale depends on
        each config's activations, so it runs in host float64 exactly like
        the oracle's ``quantize_int8`` -- the second GEMM's input codes, and
        the final integer outputs, are bit-identical.  ``requant="device"``:
        GeLU and the quantizer run in float32 torch and the (D, T, F) hidden
        tensor never leaves the device between the GEMMs.  float32 can round
        an isolated hidden code one step differently where ``h / scale`` lands
        within an ulp of a .5 boundary, so BEHAV agrees with the host path to
        ~1e-3 percentage points (held at atol 2e-2, as in the reference), not
        bitwise.  Either way the per-config hidden codes take the gather
        routes of ``table_matmul_torch``.
        """
        batch = _as_batch(tables)
        n_bits = batch.n_bits
        self._prepare(n_bits)
        self._ensure_reference()
        ref = self._ref_out
        denom = float(np.linalg.norm(ref)) or 1.0

        h_int = table_matmul_torch(batch, self._x_codes, self._w1_codes)
        if self.requant == "device":
            h_codes, sh = _gelu_requant_torch(h_int, float(self._sx * self._s1), n_bits)
            sh = sh.cpu().numpy().astype(np.float64)
        else:
            h = h_int.cpu().numpy().astype(np.float64)
            h = _gelu(h * (self._sx * self._s1))                # (D, T, F)
            d = h.shape[0]
            h_codes = np.empty(h.shape, dtype=np.int32)  # device dtype, exact
            sh = np.empty(d, dtype=np.float64)
            for i in range(d):  # per-config scales, exactly the oracle's
                h_codes[i], sh[i] = quantize_int8(h[i], n_bits=n_bits)
        y = table_matmul_torch(batch, h_codes, self._w2_codes).cpu().numpy()
        y = y.astype(np.float64)
        d = y.shape[0]
        y *= (sh * self._s2)[:, None, None]
        return np.array(
            [100.0 * float(np.linalg.norm(y[i] - ref)) / denom for i in range(d)],
            dtype=np.float64,
        )
