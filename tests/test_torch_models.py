"""The port's LM stacks vs the reference, at reduced granite-3-2b and reduced
mamba2-130m in f32.

Parameters come from the reference's ``init_params`` and cross over by name
(``convert.params_from_jax``), so both packages compute from the same
weights; tokens come from ``SyntheticLM`` (numpy, equal in both).  The
reference runs its XLA paths on the CPU: ``chunked_attention`` inside
``forward`` and ``ref.ref_flash_attention`` (its Pallas wrappers do not run on
the installed JAX).  Tolerances: kernel K7's plain version to ``rtol=5e-6``
(the reference's flash-attention spec tolerance), model logits to
``atol=2e-3, rtol=1e-3`` (``tests/test_models_smoke.py``'s prefill/decode
tolerance).  The Mamba-2 prefill is 40 tokens, three chunks of 16 with the
last ragged, so the cross-chunk carry is exercised (12 tokens, as in
``tests/test_models_smoke.py``, would be a single chunk).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.registry import get_arch as ref_get_arch
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.kernels.ref import ref_flash_attention
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models.attention import chunked_attention as ref_chunked_attention
from repro.models.attention import direct_attention as ref_direct_attention
from repro.models.model import forward as ref_forward
from repro.models.model import logits_fn as ref_logits_fn
from repro.models.model import model_spec as ref_model_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import count_params as ref_count_params
from repro.models.spec import init_params as ref_init_params

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import init_cache, make_decode_step, make_prefill_step
from repro_torch.models.attention import direct_attention
from repro_torch.models.model import cache_spec, forward, logits_fn, model_spec
from repro_torch.models.spec import _leaf_paths, count_params, init_params

ATOL, RTOL = 2e-3, 1e-3
SHAPE = (2, 16)              # batch, tokens of the model tests


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def granite():
    """Reduced granite in f32: reference params, the port's copy, tokens."""
    rcfg = ref_get_arch("granite-3-2b").reduced()
    cfg = get_arch("granite-3-2b").reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    toks = SyntheticLM(cfg, ShapeConfig("smoke", SHAPE[1], SHAPE[0], "train")).batch(0)["tokens"]
    return rcfg, cfg, rparams, params, toks


@pytest.fixture(scope="module")
def ref_logits(granite):
    """The reference's full-context logits and its prefill(12) + decode(4) logits."""
    rcfg, _, rparams, _, toks = granite
    x, _, _ = jax.jit(lambda p, t: ref_forward(p, rcfg, BASE_RULES, t, mode="train"))(
        rparams, jnp.asarray(toks))
    full = np.asarray(ref_logits_fn(rparams, rcfg, BASE_RULES, x))
    pre = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=SHAPE[1]))
    dec = jax.jit(ref_decode_step(rcfg, BASE_RULES))
    lg, cache = pre(rparams, jnp.asarray(toks[:, :12]))
    steps = [np.asarray(lg[:, 0])]
    for i in range(12, 16):
        lg, cache = dec(rparams, cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        steps.append(np.asarray(lg[:, 0]))
    return full, steps


def _qkv(seed, b, h, g, sq, skv, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, hd)).astype(np.float32),
            rng.standard_normal((b, g, skv, hd)).astype(np.float32),
            rng.standard_normal((b, g, skv, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# Configs, specs, parameters
# ---------------------------------------------------------------------------


def test_config_and_spec_match_reference():
    for full in (False, True):
        rcfg, cfg = ref_get_arch("granite-3-2b"), get_arch("granite-3-2b")
        if not full:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        want = {p: (s.shape, s.axes, s.init, s.scale)
                for p, s in _leaf_paths(ref_model_spec(rcfg))}
        got = {p: (s.shape, s.axes, s.init, s.scale) for p, s in _leaf_paths(model_spec(cfg))}
        assert got == want
        assert count_params(model_spec(cfg)) == ref_count_params(ref_model_spec(rcfg))
    full_cfg = get_arch("granite-3-2b")
    assert (full_cfg.n_layers, full_cfg.d_model, full_cfg.n_heads, full_cfg.kv_heads,
            full_cfg.resolved_head_dim, full_cfg.d_ff, full_cfg.vocab) == (
        40, 2048, 32, 8, 64, 8192, 49155)


def test_unported_archs_and_mixers_raise():
    """Every arch and mixer of the reference is ported: what still raises is
    an arch id or a mixer / mlp kind the reference does not know either."""
    with pytest.raises(ValueError, match="unknown"):
        get_arch("gpt-17")
    from dataclasses import replace

    from repro_torch.configs.base import StageConfig
    from repro_torch.models.model import cache_spec

    cfg = get_arch("granite-3-2b").reduced()
    for layers, what in (((("conv", "dense"),), "unknown mixer 'conv'"),
                         ((("attn", "glu"),), "unknown mlp 'glu'")):
        bad = replace(cfg, stages=(StageConfig(repeats=1, layers=layers),))
        with pytest.raises(ValueError, match=what):
            model_spec(bad)
        with pytest.raises(ValueError, match=what):
            cache_spec(bad, 1, 8)


def test_params_from_jax_covers_every_leaf(granite):
    rcfg, cfg, rparams, params, _ = granite
    want = dict(_leaf_paths(jax.tree.map(np.asarray, rparams)))
    got = dict(_leaf_paths(params))
    assert got.keys() == want.keys() == {p for p, _ in _leaf_paths(model_spec(cfg))}
    for path, arr in want.items():
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)
    tree = jax.tree.map(np.asarray, rparams)
    del tree["stages"]["0"]["0"]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(tree, cfg, device="cpu")
    bf16 = params_from_jax(jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), rparams),
                           device="cpu")
    np.testing.assert_array_equal(bf16["norm_f"].float().numpy(), np.ones(cfg.d_model))
    assert bf16["embed"]["tok"].dtype == torch.bfloat16


def test_init_params_seeds_each_leaf():
    cfg = get_arch("granite-3-2b").reduced()
    a = init_params(model_spec(cfg), seed=3, dtype=torch.float32, device="cpu")
    b = init_params(model_spec(cfg), seed=3, dtype=torch.float32, device="cpu")
    c = init_params(model_spec(cfg), seed=4, dtype=torch.float32, device="cpu")
    for (path, x), (_, y), (_, z) in zip(_leaf_paths(a), _leaf_paths(b), _leaf_paths(c)):
        assert torch.equal(x, y), path
        if "norm" not in path:
            assert not torch.equal(x, z), path
    # the reference's fan_in is a leaf's second-to-last axis: heads, for wq
    wq = a["stages"]["0"]["0"]["mixer"]["wq"]
    assert abs(float(wq.std()) * wq.shape[-2] ** 0.5 - 1.0) < 0.05
    assert a["norm_f"].eq(1).all()
    assert init_params(model_spec(cfg), device="cpu")["norm_f"].dtype == torch.bfloat16
    cache = init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    assert cache["0"]["0"]["k"].shape == (cfg.stages[0].repeats, 2, 8, cfg.kv_heads,
                                          cfg.resolved_head_dim)
    assert {p for p, _ in _leaf_paths(cache)} == {p for p, _ in _leaf_paths(cache_spec(cfg, 2, 8))}


# ---------------------------------------------------------------------------
# K7's plain version and the decode attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [5, 24, 130])
def test_flash_attention_plain_matches_reference(s):
    q, k, v = _qkv(s, 2, 4, 2, s, s, 16)
    want = np.asarray(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = fa.flash_attention_plain(*t)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-6, atol=5e-6)
    # on CPU tensors the wrapper is the plain version, launching nothing
    before = fa.flash_attention.launches
    np.testing.assert_array_equal(fa.flash_attention(*t).numpy(), got.numpy())
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("offset, sq", [(7, 9), (20, 5)])
def test_flash_attention_offset_and_kv_len_match_chunked(offset, sq):
    """A prefill into a filled cache: row i at position offset + i, keys past
    ``kv_len`` masked -- what the reference's chunked attention computes."""
    skv = offset + sq + 6                      # cache capacity beyond kv_len
    q, k, v = _qkv(offset, 2, 4, 2, sq, skv, 16)
    k[:, :, offset + sq:] = 1e3                # garbage past kv_len must not count
    kv_len = offset + sq
    want = ref_chunked_attention(
        jnp.asarray(q.transpose(0, 2, 1, 3)), jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), causal=True,
        q_positions=offset + jnp.arange(sq, dtype=jnp.int32), kv_len=kv_len,
        q_chunk=4, kv_chunk=8)
    got = fa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                   q_offset=offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=5e-6, atol=5e-6)


def test_direct_attention_matches_reference():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    pos = np.array([6], np.int32)
    want = ref_direct_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                q_positions=jnp.asarray(pos), kv_len=7)
    got = direct_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True,
                           q_positions=torch.from_numpy(pos).long(), kv_len=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_flash_attention_checks_its_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 4, 2, 6, 6, 16))
    with pytest.raises(ValueError, match="KV groups"):
        fa.flash_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention(q, k, v, kv_len=7)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.double(), v)


# ---------------------------------------------------------------------------
# The exact model: forward, prefill and decode
# ---------------------------------------------------------------------------


def test_forward_logits_match_reference(granite, ref_logits):
    _, cfg, _, params, toks = granite
    x, aux, cache = forward(params, cfg, torch.from_numpy(toks).long(), mode="train")
    assert cache is None and float(aux) == 0.0
    got = logits_fn(params, cfg, x)
    np.testing.assert_allclose(got.numpy(), ref_logits[0], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_decode_match_reference(granite, ref_logits, impl):
    _, cfg, _, params, toks = granite
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    pre = make_prefill_step(cfg, max_seq=SHAPE[1], ctx=ctx)
    dec = make_decode_step(cfg, ctx=ctx)
    t = torch.from_numpy(toks).long()
    lg, cache = pre(params, t[:, :12])
    assert lg.shape == (SHAPE[0], 1, cfg.vocab)
    np.testing.assert_allclose(lg[:, 0].numpy(), ref_logits[1][0], atol=ATOL, rtol=RTOL)
    for j, i in enumerate(range(12, 16)):
        lg, cache = dec(params, cache, t[:, i:i + 1], i)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref_logits[1][j + 1], atol=ATOL, rtol=RTOL)
        if i < SHAPE[1] - 1:     # the port's own full-context logits too
            np.testing.assert_allclose(lg[:, 0].numpy(), ref_logits[0][:, i], atol=ATOL,
                                       rtol=RTOL)


def test_prefill_decode_match_own_full_context(granite):
    _, cfg, _, params, toks = granite
    t = torch.from_numpy(toks).long()
    x, _, _ = forward(params, cfg, t, mode="train")
    full = logits_fn(params, cfg, x)
    ctx = ExecutionContext(device="cpu")
    lg, cache = make_prefill_step(cfg, max_seq=SHAPE[1], ctx=ctx)(params, t[:, :12])
    torch.testing.assert_close(lg[:, 0], full[:, 11], atol=ATOL, rtol=RTOL)
    dec = make_decode_step(cfg, ctx=ctx)
    for i in range(12, 15):
        lg, cache = dec(params, cache, t[:, i:i + 1], i)
        torch.testing.assert_close(lg[:, 0], full[:, i], atol=ATOL, rtol=RTOL)


def test_synthetic_tokens_match_reference():
    cfg, rcfg = get_arch("granite-3-2b"), ref_get_arch("granite-3-2b")
    for seed, (b, s) in ((0, (4, 144)), (7, (2, 33))):
        got = SyntheticLM(cfg, ShapeConfig("serve", s, b, "train"), seed=seed).batch(3)
        want = RefSyntheticLM(rcfg, RefShapeConfig("serve", s, b, "train"), seed=seed).batch(3)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])


# ---------------------------------------------------------------------------
# The Mamba-2 stack: prefill through K8's route, O(1) decode
# ---------------------------------------------------------------------------

M_PROMPT, M_STEPS = 40, 4


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-130m in f32: reference params, the port's copy, tokens."""
    rcfg = ref_get_arch("mamba2-130m").reduced()
    cfg = get_arch("mamba2-130m").reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    total = M_PROMPT + M_STEPS
    toks = SyntheticLM(cfg, ShapeConfig("smoke", total, 2, "train")).batch(0)["tokens"]
    return rcfg, cfg, rparams, params, toks


@pytest.fixture(scope="module")
def mamba_ref(mamba):
    """The reference's full-context logits, its prefill(40) + decode(4) logits
    and its caches after the prefill."""
    rcfg, _, rparams, _, toks = mamba
    total = M_PROMPT + M_STEPS
    x, _, _ = jax.jit(lambda p, t: ref_forward(p, rcfg, BASE_RULES, t, mode="train"))(
        rparams, jnp.asarray(toks))
    full = np.asarray(ref_logits_fn(rparams, rcfg, BASE_RULES, x))
    pre = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=total))
    dec = jax.jit(ref_decode_step(rcfg, BASE_RULES))
    lg, cache = pre(rparams, jnp.asarray(toks[:, :M_PROMPT]))
    prefill_cache = jax.tree.map(np.asarray, cache)
    steps = [np.asarray(lg[:, 0])]
    for i in range(M_PROMPT, total):
        lg, cache = dec(rparams, cache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        steps.append(np.asarray(lg[:, 0]))
    return full, steps, prefill_cache


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba_prefill_decode_match_reference(mamba, mamba_ref, impl):
    _, cfg, _, params, toks = mamba
    full, steps, ref_cache = mamba_ref
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    pre = make_prefill_step(cfg, max_seq=M_PROMPT + M_STEPS, ctx=ctx)
    dec = make_decode_step(cfg, ctx=ctx)
    t = torch.from_numpy(toks).long()
    lg, cache = pre(params, t[:, :M_PROMPT])
    assert lg.shape == (2, 1, cfg.vocab)
    np.testing.assert_allclose(lg[:, 0].numpy(), steps[0], atol=ATOL, rtol=RTOL)
    # the prefill wrote the conv tail and the f32 state into the stacked cache
    for leaf in ("conv", "state"):
        got = cache["0"]["0"][leaf]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref_cache["0"]["0"][leaf], atol=ATOL,
                                   rtol=RTOL, err_msg=leaf)
    for j, i in enumerate(range(M_PROMPT, M_PROMPT + M_STEPS)):
        lg, cache = dec(params, cache, t[:, i:i + 1], i)
        np.testing.assert_allclose(lg[:, 0].numpy(), steps[j + 1], atol=ATOL, rtol=RTOL)
        if i < M_PROMPT + M_STEPS - 1:     # the reference's full-context logits too
            np.testing.assert_allclose(lg[:, 0].numpy(), full[:, i], atol=ATOL, rtol=RTOL)


def test_mamba_prefill_decode_match_own_full_context(mamba):
    _, cfg, _, params, toks = mamba
    t = torch.from_numpy(toks).long()
    ctx = ExecutionContext(device="cpu")
    x, aux, cache = forward(params, cfg, t, mode="train", ctx=ctx)
    assert cache is None and float(aux) == 0.0
    full = logits_fn(params, cfg, x)
    lg, cache = make_prefill_step(cfg, max_seq=M_PROMPT + M_STEPS, ctx=ctx)(
        params, t[:, :M_PROMPT])
    torch.testing.assert_close(lg[:, 0], full[:, M_PROMPT - 1], atol=ATOL, rtol=RTOL)
    dec = make_decode_step(cfg, ctx=ctx)
    for i in range(M_PROMPT, M_PROMPT + M_STEPS - 1):
        lg, cache = dec(params, cache, t[:, i:i + 1], i)
        torch.testing.assert_close(lg[:, 0], full[:, i], atol=ATOL, rtol=RTOL)
