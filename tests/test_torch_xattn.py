"""Cross-attention and non-causal attention in the port vs the reference.

``xattn_kv`` and ``xattn_apply`` (plain and with the VLM's tanh gate) at the
reduced whisper-medium and llama-3.2-vision-90b configs in f32: a prefill
(Sq = 8 > 4, K7's plain version on the CPU, ``causal=False``) and a decode
step (Sq = 1, the direct softmax) over encoder/image states of another
length, on parameters drawn by the reference's ``init_params``
(``xattn_spec``) with a non-zero gate.  ``flash_attention_plain`` and the K7
wrapper on CPU tensors, non-causal at Sq != Skv with Skv off the 64-key tile
(1,500 and 1,600 at full width, small here), against the reference's
``chunked_attention(causal=False)``.  Tolerance ``atol=2e-5, rtol=1e-4``
(f32, sums in another order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_get_arch
from repro.models.attention import chunked_attention as ref_chunked_attention
from repro.models.attention import xattn_apply as ref_xattn_apply
from repro.models.attention import xattn_kv as ref_xattn_kv
from repro.models.attention import xattn_spec as ref_xattn_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import init_params as ref_init_params

from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.models.attention import xattn_apply, xattn_kv, xattn_spec
from repro_torch.models.spec import _leaf_paths

ATOL, RTOL = 2e-5, 1e-4


@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_xattn_spec_matches_reference(arch):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    want = {k: (s.shape, s.axes, s.init) for k, s in _leaf_paths(ref_xattn_spec(rcfg))}
    assert {k: (s.shape, s.axes, s.init) for k, s in _leaf_paths(xattn_spec(cfg))} == want


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("sq", [8, 1])
@pytest.mark.parametrize("arch", ["whisper-medium", "llama-3.2-vision-90b"])
def test_xattn_kv_and_apply_match_reference(arch, sq, gated):
    rcfg, cfg = ref_get_arch(arch).reduced(), get_arch(arch).reduced()
    rp = dict(ref_init_params(ref_xattn_spec(rcfg), seed=7, dtype=jnp.float32))
    rp["gate"] = jnp.asarray([0.7], jnp.float32)       # tanh(0) would hide the output
    p = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(sq)
    n_enc = cfg.encoder.n_ctx if cfg.encoder else cfg.n_img_tokens
    enc = rng.standard_normal((2, n_enc + 3, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, sq, cfg.d_model)).astype(np.float32)

    rkv = ref_xattn_kv(rp, jnp.asarray(enc))
    kv = xattn_kv(p, torch.from_numpy(enc))
    for a, e in zip(kv, rkv):
        assert a.shape == (2, n_enc + 3, cfg.kv_heads, cfg.resolved_head_dim)
        np.testing.assert_allclose(a.numpy(), np.array(e), atol=ATOL, rtol=RTOL)
    want = ref_xattn_apply(rp, jnp.asarray(x), rcfg, BASE_RULES, kv=rkv, gated=gated)
    for impl in ("kernel", "plain"):
        got = xattn_apply(p, torch.from_numpy(x), cfg, kv=kv, gated=gated, impl=impl)
        np.testing.assert_allclose(got.numpy(), np.array(want), atol=ATOL, rtol=RTOL,
                                   err_msg=impl)


def test_gate_at_zero_silences_the_vlm_cross_attention():
    """The VLM's gate is initialized to 0 (``init="zeros"``), as the
    reference's: at init its cross-attention adds nothing."""
    cfg = get_arch("llama-3.2-vision-90b").reduced()
    rp = ref_init_params(ref_xattn_spec(ref_get_arch("llama-3.2-vision-90b").reduced()),
                         seed=1, dtype=jnp.float32)
    p = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu")
    assert not p["gate"].any()
    enc = torch.randn((1, 9, cfg.d_model))
    out = xattn_apply(p, torch.randn((1, 6, cfg.d_model)), cfg, kv=xattn_kv(p, enc), gated=True)
    assert not out.any()


@pytest.mark.parametrize("sq, skv, h, g, hd", [(8, 16, 4, 4, 16), (9, 77, 4, 2, 16),
                                               (16, 100, 8, 8, 64), (5, 130, 8, 1, 32),
                                               (70, 65, 4, 2, 16)])
def test_flash_attention_plain_non_causal_matches_chunked_attention(sq, skv, h, g, hd):
    """Non-causal at Sq != Skv: the reference's blockwise attention (chunks of
    16, so a ragged last chunk) against K7's plain version and the K7 wrapper
    on CPU tensors (which returns the plain version)."""
    rng = np.random.default_rng(skv)
    q = rng.standard_normal((2, sq, h, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, g, hd)).astype(np.float32) for _ in range(2))
    want = ref_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                 q_positions=jnp.arange(sq, dtype=jnp.int32), kv_len=skv,
                                 q_chunk=16, kv_chunk=16)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    for fn in (flash_attention_plain, flash_attention):
        got = fn(qt, kt, vt, causal=False, kv_len=skv).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), np.array(want), atol=ATOL, rtol=RTOL,
                                   err_msg=fn.__name__)
    # keys past kv_len are masked, non-causal too
    part = ref_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                 q_positions=jnp.arange(sq, dtype=jnp.int32), kv_len=skv - 3,
                                 q_chunk=16, kv_chunk=16)
    got = flash_attention_plain(qt, kt, vt, causal=False, kv_len=skv - 3).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.array(part), atol=ATOL, rtol=RTOL)
