"""The port's blockwise attention against the reference's ``chunked_attention``.

``kernels.flash_attention.blockwise_attention`` (through the model's
``models.attention.chunked_attention``, the reference's name and ``(B, S, H,
hd)`` layout) is the attention of the model's prefill and training passes on
the CPU, with ``impl="plain"``, and of MLA at Sq > 4; its backward is
``FlashAttentionFn``'s.  Inputs come from a numpy seed.

* **Against the reference** in float32: the output within ``atol=rtol=1e-5``
  of ``repro.models.attention.chunked_attention`` (jnp on the CPU), the q, k
  and v gradients within ``atol=rtol=1e-4`` of ``jax.grad`` of it: causal
  and not, GQA 4/2, Sq != Skv, ``q_offset`` > 0 with ``kv_len`` < Skv, a
  value width other than the key width (MLA's reduced 24/16); the
  reference with causal block skipping on and off (its ``q_start`` given or
  not), where the port always skips.  Skipping leaves the output and the
  gradients bit for bit as a scan of every KV block gives them.
* **Against the direct plain version** in float64: the output and the
  gradients within 1e-10 of ``flash_attention_plain`` and its autodiff.
* **Memory**: no tensor of B H Sq Skv elements is made in the forward or
  the backward (S = 256, chunks 32), where ``flash_attention_plain`` makes
  one; ``lower_step``'s peak above the arguments for the reduced granite
  train cell grows at most 2.5x from S = 256 to 512 (chunks 64), where the
  direct softmax in its place grows about 4x.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX

import jax.numpy as jnp  # noqa: E402

from repro.models.attention import chunked_attention as ref_chunked_attention  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch, rules_for  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.lowering import lower_step  # noqa: E402
from repro_torch.models import attention  # noqa: E402

# (causal, Sq, Skv, q_offset, kv_len, H, G, key width, value width, q_chunk, kv_chunk)
CASES = {
    "causal": (True, 37, 37, 0, 37, 4, 2, 16, 16, 8, 8),
    "non-causal-cross": (False, 20, 45, 0, 45, 4, 2, 16, 16, 8, 16),
    "offset-kv_len": (True, 9, 40, 20, 29, 4, 2, 16, 16, 4, 8),
    "mla-widths": (True, 33, 33, 0, 33, 4, 1, 24, 16, 16, 16),
}
B = 2


def _inputs(case, seed=0, dtype=np.float32):
    causal, sq, skv, off, kv_len, h, g, hd, hdv, *_ = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, sq, h, hd)).astype(dtype)
    k = rng.standard_normal((B, skv, g, hd)).astype(dtype)
    v = rng.standard_normal((B, skv, g, hdv)).astype(dtype)
    k[:, kv_len:] = 1e3                       # garbage past kv_len must not count
    w = rng.standard_normal((B, sq, h, hdv)).astype(dtype)
    return q, k, v, w


def _port(case, q, k, v, w):
    causal, sq, skv, off, kv_len, *_, qc, kc = CASES[case]
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = attention.chunked_attention(*ins, causal=causal, q_offset=off, kv_len=kv_len,
                                      q_chunk=qc, kv_chunk=kc)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)
    return out.detach(), grads


def _reference(case, q, k, v, w, block_skip):
    causal, sq, skv, off, kv_len, *_, qc, kc = CASES[case]

    def f(q, k, v):
        return ref_chunked_attention(
            q, k, v, causal=causal, q_positions=off + jnp.arange(sq, dtype=jnp.int32),
            kv_len=kv_len, q_chunk=qc, kv_chunk=kc,
            q_start=off if block_skip else None)

    out = f(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *t: (f(*t) * jnp.asarray(w)).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("block_skip", [True, False], ids=["skip", "no-skip"])
@pytest.mark.parametrize("case", list(CASES))
def test_blockwise_attention_matches_the_references_chunked_attention(case, block_skip):
    q, k, v, w = _inputs(case)
    out, grads = _port(case, q, k, v, w)
    want, want_grads = _reference(case, q, k, v, w, block_skip)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5, rtol=1e-5)
    for name, g, gw in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), gw, atol=1e-4, rtol=1e-4, err_msg=name)


_KV_BLOCKS = fa._kv_blocks


def _every_block(i1, skv, *, causal, q_offset, kv_chunk):
    """``_kv_blocks`` without the causal skip: every KV block."""
    return _KV_BLOCKS(i1, skv, causal=False, q_offset=q_offset, kv_chunk=kv_chunk)


@pytest.mark.parametrize("case", list(CASES))
def test_block_skip_leaves_the_bits_as_they_are(case, monkeypatch):
    q, k, v, w = _inputs(case, seed=1)
    o1, g1 = _port(case, q, k, v, w)
    monkeypatch.setattr(fa, "_kv_blocks", _every_block)
    o2, g2 = _port(case, q, k, v, w)
    assert torch.equal(o1, o2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][7] == CASES[c][8]])
def test_float64_equals_the_direct_plain_version_and_its_autodiff(case):
    causal, sq, skv, off, kv_len, *_, qc, kc = CASES[case]
    q, k, v, w = (torch.from_numpy(x).transpose(1, 2) for x in _inputs(case, 2, np.float64))
    kw = dict(causal=causal, q_offset=off, kv_len=kv_len)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return out.detach(), torch.autograd.grad((out * w).sum(), ins)

    got = run(lambda *t: fa.blockwise_attention(*t, q_chunk=qc, kv_chunk=kc, **kw))
    want = run(lambda *t: fa.flash_attention_plain(*t, **kw))
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)


class _Largest(torch.utils._python_dispatch.TorchDispatchMode):
    """The most elements of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.most = max(self.most, t.numel())
        return out


def test_no_tensor_of_the_score_matrix_is_made():
    b, h, g, s, hd = 1, 4, 2, 256, 16
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(b, h, s, hd, generator=gen, requires_grad=True)
    k, v = (torch.randn(b, g, s, hd, generator=gen, requires_grad=True) for _ in range(2))
    seen = {}
    for name, fn in (("blockwise", lambda: fa.blockwise_attention(q, k, v, q_chunk=32,
                                                                  kv_chunk=32)),
                     ("direct", lambda: fa.flash_attention_plain(q, k, v))):
        with _Largest() as mode:
            fn().sum().backward()
        seen[name] = mode.most
    assert seen["blockwise"] < b * h * s * s <= seen["direct"], seen
    assert seen["blockwise"] <= b * h * s * hd


def _direct(q, k, v, *, causal, q_offset=0, kv_len=None, scale=None, **_):
    """The direct softmax, whole S x S scores, in chunked_attention's place."""
    out = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   causal=causal, scale=scale, q_offset=q_offset,
                                   kv_len=kv_len)
    return out.transpose(1, 2)


def _temp_bytes(seq):
    # chunks of 64 (the reduced configs' are 16): a trace on fake tensors
    # costs host time per op, ~0.4 ms, and at 16 the S = 512 step runs 141k
    cfg = replace(get_arch("granite-3-2b").reduced(), attn_q_chunk=64, attn_kv_chunk=64)
    shape = ShapeConfig("t", seq, 2, "train")
    rec = lower_step(cfg, shape, None, rules_for(cfg, shape), device="cpu")
    return rec["peak_bytes"] - rec["argument_size_in_bytes"]


def test_a_train_cells_traced_peak_grows_linearly_in_s(monkeypatch):
    blockwise = _temp_bytes(512) / _temp_bytes(256)
    monkeypatch.setattr(attention, "chunked_attention", _direct)
    direct = _temp_bytes(512) / _temp_bytes(256)
    assert blockwise <= 2.5 and direct >= 3.5, (blockwise, direct)
