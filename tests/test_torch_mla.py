"""MLA (DeepSeek-V3's absorbed latent attention) in the port vs the reference.

``mla_apply`` at the reduced deepseek-v3-671b config in f32, on parameters
drawn by the reference's ``init_params`` (``mla_spec``) and carried over as
numpy: a prefill without a cache, a prefill into a ``{ckv, kpe}`` cache and
a decode step on it, exact and with the MLA entries of an AxO deployment.
The reference computes the prefill's attention with its XLA
``chunked_attention`` and the decode step's with ``direct_attention``; the
port computes both with its plain ``direct_attention`` (K7 is built for equal
q and v widths).  Tolerance: ``atol=2e-5, rtol=1e-4`` on the outputs and the
cache rows (f32, sums in another order), and 1e-3 relative norm for the AxO
outputs (``tests/test_torch_dense_archs.py``'s AxO contract).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.axo import AxOOperator as RefAxOOperator
from repro.axo import deploy_axo as ref_deploy_axo
from repro.configs.registry import get_arch as ref_get_arch
from repro.core.operator_model import accurate_config as ref_accurate_config
from repro.core.operator_model import spec_for as ref_spec_for
from repro.models.attention import mla_apply as ref_mla_apply
from repro.models.attention import mla_spec as ref_mla_spec
from repro.models.model import model_spec as ref_model_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import init_params as ref_init_params

from repro_torch.axo import AxOOperator, deploy_axo
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.models import attention
from repro_torch.models.attention import mla_apply, mla_spec
from repro_torch.models.model import _at, cache_spec
from repro_torch.models.spec import _leaf_paths

ATOL, RTOL = 2e-5, 1e-4
B, S, CAP = 2, 7, 12


def _tree(x):
    return jax.tree.map(np.asarray, x)


@pytest.fixture(scope="module")
def mla():
    rcfg = ref_get_arch("deepseek-v3-671b").reduced()
    cfg = get_arch("deepseek-v3-671b").reduced()
    rp = ref_init_params(ref_mla_spec(rcfg), seed=5, dtype=jnp.float32)
    p = params_from_jax(_tree(rp), device="cpu")
    x = np.random.default_rng(0).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, p, x


def test_mla_spec_matches_reference(mla):
    rcfg, cfg, rp, p, _ = mla
    want = {k: (s.shape, s.axes, s.init) for k, s in _leaf_paths(ref_mla_spec(rcfg))}
    assert {k: (s.shape, s.axes, s.init) for k, s in _leaf_paths(mla_spec(cfg))} == want
    # the decode cache: one latent row and one rope key row a position
    leaves = dict(_leaf_paths(cache_spec(cfg, B, CAP)))
    m = cfg.mla
    assert leaves["/0/0/ckv"].shape == (cfg.stages[0].repeats, B, CAP, m.kv_lora_rank)
    assert leaves["/1/0/kpe"].shape == (cfg.stages[1].repeats, B, CAP, m.rope_head_dim)


def test_mla_prefill_without_cache_matches_reference(mla):
    rcfg, cfg, rp, p, x = mla
    pos = np.arange(S, dtype=np.int32)
    want, _ = ref_mla_apply(rp, jnp.asarray(x), rcfg, BASE_RULES, positions=jnp.asarray(pos),
                            q_start=0)
    got, cache = mla_apply(p, torch.from_numpy(x), cfg, positions=torch.arange(S))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=ATOL, rtol=RTOL)


def _ref_cache(rcfg):
    m = rcfg.mla
    return {"ckv": jnp.zeros((B, CAP, m.kv_lora_rank), jnp.float32),
            "kpe": jnp.zeros((B, CAP, m.rope_head_dim), jnp.float32)}


def test_mla_prefill_and_decode_with_cache_match_reference(mla):
    """The prefill fills the latent cache in place (rows 0..S-1, the rest
    zero) and a decode step at position S attends over it, as the reference's
    functional cache does."""
    rcfg, cfg, rp, p, x = mla
    rc = _ref_cache(rcfg)
    cache = {k: torch.zeros(v.shape) for k, v in rc.items()}
    want, rc = ref_mla_apply(rp, jnp.asarray(x), rcfg, BASE_RULES,
                             positions=jnp.arange(S, dtype=jnp.int32), cache=rc,
                             cache_index=jnp.int32(0), q_start=0)
    got, cache2 = mla_apply(p, torch.from_numpy(x), cfg, positions=torch.arange(S),
                            cache=cache, cache_index=0)
    assert cache2 is cache
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=ATOL, rtol=RTOL)
    for k in ("ckv", "kpe"):
        np.testing.assert_allclose(cache[k].numpy(), np.array(rc[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
        assert not cache[k][:, S:].any()
    x1 = np.random.default_rng(1).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    want1, rc = ref_mla_apply(rp, jnp.asarray(x1), rcfg, BASE_RULES,
                              positions=jnp.asarray([S], jnp.int32), cache=rc,
                              cache_index=jnp.int32(S))
    got1, _ = mla_apply(p, torch.from_numpy(x1), cfg, positions=torch.tensor([S]),
                        cache=cache, cache_index=S)
    np.testing.assert_allclose(got1.numpy(), np.array(want1), atol=ATOL, rtol=RTOL)
    for k in ("ckv", "kpe"):
        np.testing.assert_allclose(cache[k].numpy(), np.array(rc[k]), atol=ATOL, rtol=RTOL)


def test_mla_runs_no_flash_attention(mla, monkeypatch):
    """MLA's attention at the prefill is the blockwise ``chunked_attention``
    at widths r + rope and r, once, in the config's chunks: K7 is never
    called, and nothing catches a refusal."""
    rcfg, cfg, rp, p, x = mla
    seen = []

    def refuse(*args, **kw):
        raise AssertionError("MLA must not call flash attention")

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1], kw["q_chunk"], kw["kv_chunk"]))
        return chunked(q, k, v, **kw)

    chunked = attention.chunked_attention
    monkeypatch.setattr(attention, "flash_attention", refuse)
    monkeypatch.setattr(attention, "chunked_attention", spy)
    out, _ = mla_apply(p, torch.from_numpy(x), cfg, positions=torch.arange(S))
    assert out.shape == (B, S, cfg.d_model)
    m = cfg.mla
    assert seen == [(m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank, cfg.attn_q_chunk,
                     cfg.attn_kv_chunk)]


def test_mla_axo_entries_match_reference(mla):
    """With the MLA layer's AxO entries (wq_a, wq_b, wkv_a, wo; wkv_b exact)
    the prefill with a cache and a decode step match the reference's
    ``deploy_axo(impl="xla")`` outputs."""
    rcfg, cfg, *_ = mla
    rparams = ref_init_params(ref_model_spec(rcfg), seed=2, dtype=jnp.float32)
    params = params_from_jax(_tree(rparams), cfg, device="cpu")
    rop_cfg = ref_accurate_config(ref_spec_for(8))
    rop_cfg[0] = 0
    op_cfg = accurate_config(spec_for(8))
    op_cfg[0] = 0
    rdep = ref_deploy_axo(rparams, RefAxOOperator.from_config(rop_cfg, rank=16), rcfg,
                          impl="xla", layers=("attn",))
    dep = deploy_axo(params, AxOOperator.from_config(op_cfg, rank=16), cfg, layers=("attn",),
                     ctx=ExecutionContext(device="cpu"))
    assert set(dep.stages["1"]["0"]["mixer"]) == {"wq_a", "wq_b", "wkv_a", "wo"}
    assert dep.n_entries == rdep.n_entries == 2 * 4
    rlay = jax.tree.map(lambda a: a[0], rparams["stages"]["1"]["0"]["mixer"])
    rent = jax.tree.map(lambda a: a[0], rdep.stages["1"]["0"]["mixer"])
    lay = _at(params["stages"]["1"]["0"]["mixer"], 0)
    ent = _at(dep.stages["1"]["0"]["mixer"], 0)
    x = np.random.default_rng(3).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rc = _ref_cache(rcfg)
    cache = {k: torch.zeros(v.shape) for k, v in rc.items()}
    want, rc = ref_mla_apply(rlay, jnp.asarray(x), rcfg, BASE_RULES,
                             positions=jnp.arange(S, dtype=jnp.int32), cache=rc,
                             cache_index=jnp.int32(0), q_start=0, axo=(rdep, rent))
    got, _ = mla_apply(lay, torch.from_numpy(x), cfg, positions=torch.arange(S), cache=cache,
                       cache_index=0, axo=(dep, ent))
    rel = float(np.linalg.norm(got.numpy() - np.array(want)) / np.linalg.norm(np.array(want)))
    assert rel < 1e-3
    x1 = np.random.default_rng(4).standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    want1, _ = ref_mla_apply(rlay, jnp.asarray(x1), rcfg, BASE_RULES,
                             positions=jnp.asarray([S], jnp.int32), cache=rc,
                             cache_index=jnp.int32(S), axo=(rdep, rent))
    got1, _ = mla_apply(lay, torch.from_numpy(x1), cfg, positions=torch.tensor([S]),
                        cache=cache, cache_index=S, axo=(dep, ent))
    rel1 = float(np.linalg.norm(got1.numpy() - np.array(want1))
                 / np.linalg.norm(np.array(want1)))
    assert rel1 < 1e-3
