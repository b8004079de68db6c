"""The port's Mamba-2 SSD path vs the reference, on the CPU.

Kernel K8's plain version (``kernels.ssd_scan.ssd_scan_plain``) is held
against the reference's Pallas ``ops.ssd_scan`` (interpret mode, as
``tests/test_kernels.py`` runs it) and its sequential ``ref.ref_ssd_scan``,
at that test's shapes and tolerances (2e-5 in f32, 1e-1 in bf16); a ragged S
and a nonzero entering state against the reference's XLA ``ssd_chunked`` and
the sequential recurrence (2e-5).  The port's ``mamba_apply`` and
``mamba_decode`` are held against the reference's at the reduced
mamba2-130m in f32, with the reference's parameters carried across by
``convert.params_from_jax``, to the model tests' ``atol=2e-3, rtol=1e-3``.
Inputs are drawn with numpy from fixed seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch as ref_get_arch
from repro.kernels.ops import ssd_scan as ref_pallas_ssd_scan
from repro.kernels.ref import ref_ssd_scan
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.models.sharding import BASE_RULES
from repro.models.spec import count_params as ref_count_params
from repro.models.spec import init_params as ref_init_params

from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ssd_scan as k8
from repro_torch.launch.steps import init_cache
from repro_torch.models import ssm
from repro_torch.models.model import cache_spec, model_spec
from repro_torch.models.spec import _leaf_paths, count_params

ATOL, RTOL = 2e-3, 1e-3
SCAN_TOL = {"float32": 2e-5, "bfloat16": 1e-1}     # tests/test_kernels.py's ssd tolerances
KERNEL_SHAPES = [                                   # (B, S, H, G, P, N, chunk)
    (2, 256, 4, 1, 16, 32, 64),
    (1, 128, 8, 2, 8, 16, 32),
    (1, 64, 4, 4, 8, 8, 64),                        # chunk == S (single chunk)
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b, s, h, g, p, n):
    """The reference kernel test's draws: x, B, C normal; dt in [0.01, 0.2]; a in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (h,))).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32),
            rng.standard_normal((b, s, g, n)).astype(np.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# K8's plain version vs the reference's Pallas kernel and sequential oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_plain_matches_pallas_and_sequential_reference(shape, dtype):
    b, s, h, g, p, n, chunk = shape
    x, dt, a, bm, cm = _scan_inputs(s + h + g, b, s, h, g, p, n)
    jx, jb, jc = (jnp.asarray(t, getattr(jnp, dtype)) for t in (x, bm, cm))
    y_pl, st_pl = ref_pallas_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc, chunk=chunk)
    y_sq, st_sq = ref_ssd_scan(jx, jnp.asarray(dt), jnp.asarray(a), jb, jc)
    # the same rounded inputs on the port's side
    tx, tb, tc = (_t(np.asarray(t.astype(jnp.float32))).to(getattr(torch, dtype))
                  for t in (jx, jb, jc))
    y, st = k8.ssd_scan_plain(tx, _t(dt), _t(a), tb, tc, chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    tol = SCAN_TOL[dtype]
    for want_y, want_st in ((y_pl, st_pl), (y_sq, st_sq)):
        np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=tol, rtol=tol)
    # on CPU tensors the K8 wrapper is the plain version, launching nothing
    before = k8.ssd_scan.launches
    y_w, st_w = k8.ssd_scan(tx, _t(dt), _t(a), tb, tc, chunk=chunk)
    assert torch.equal(y_w, y) and torch.equal(st_w, st)
    assert k8.ssd_scan.launches == before


@pytest.mark.parametrize("entering", [False, True], ids=["zero_state", "entering_state"])
def test_ragged_scan_matches_ssd_chunked_and_sequential(entering):
    """S = 40 at chunk 16: two full chunks and a padded one."""
    b, s, h, g, p, n, chunk = 2, 40, 4, 2, 8, 16, 16
    x, dt, a, bm, cm = _scan_inputs(40, b, s, h, g, p, n)
    init = (np.random.default_rng(1).standard_normal((b, h, p, n)).astype(np.float32)
            if entering else None)
    j_init = None if init is None else jnp.asarray(init)
    jargs = tuple(jnp.asarray(t) for t in (x, dt, a, bm, cm))
    want = ref_ssm.ssd_chunked(*jargs, chunk=chunk, init_state=j_init)
    seq = ref_ssd_scan(*jargs, init_state=j_init)
    t_init = None if init is None else _t(init)
    for impl in ("plain", "kernel"):   # "kernel" on CPU tensors: K8's plain version
        y, st = ssm.ssd_chunked(*(_t(t) for t in (x, dt, a, bm, cm)), chunk,
                                init_state=t_init, impl=impl)
        assert y.shape == (b, s, h, p)
        for wy, wst in (want, seq):
            np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=2e-5, rtol=2e-5)


def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 2, 9)).astype(np.float32)
    np.testing.assert_allclose(k8.segsum(_t(x)).numpy(), np.asarray(ref_ssm._segsum(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    xbc = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    bias = rng.standard_normal((12,)).astype(np.float32)
    want = ref_ssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(bias))
    got = ssm._causal_conv(_t(xbc), _t(w), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_ssd_scan_checks_its_inputs():
    x, dt, a, bm, cm = (_t(t) for t in _scan_inputs(0, 1, 8, 4, 2, 8, 16))
    with pytest.raises(ValueError, match="groups"):
        k8.ssd_scan(x[:, :, :3], dt[:, :, :3], a[:3], bm, cm)
    with pytest.raises(ValueError, match="shapes do not fit"):
        k8.ssd_scan(x, dt[:, :4], a, bm, cm)
    with pytest.raises(ValueError, match="init_state"):
        k8.ssd_scan(x, dt, a, bm, cm, init_state=torch.zeros(1, 4, 8, 8))
    with pytest.raises(TypeError, match="dtypes differ"):
        k8.ssd_scan(x, dt, a, bm.double(), cm)


# ---------------------------------------------------------------------------
# The mamba mixer vs the reference, at reduced mamba2-130m in f32
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_layer():
    """Layer 0's mixer parameters in both packages, from the reference's init."""
    rcfg = ref_get_arch("mamba2-130m").reduced()
    cfg = get_arch("mamba2-130m").reduced()
    rparams = ref_init_params(ref_model.model_spec(rcfg), seed=0, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rp = jax.tree.map(lambda t: t[0], rparams["stages"]["0"]["0"]["mixer"])
    p = {k: v[0] for k, v in params["stages"]["0"]["0"]["mixer"].items()}
    return rcfg, cfg, rp, p


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_mamba_apply_and_decode_match_reference(mamba_layer, impl):
    """A 40-token prefill (3 chunks of 16, ragged), then two decode steps."""
    rcfg, cfg, rp, p = mamba_layer
    rng = np.random.default_rng(7)
    xin = rng.standard_normal((2, 42, cfg.d_model)).astype(np.float32)
    r_out, (r_tail, r_state) = ref_ssm.mamba_apply(rp, jnp.asarray(xin[:, :40]), rcfg,
                                                   BASE_RULES)
    out, (tail, state) = ssm.mamba_apply(p, _t(xin[:, :40]), cfg, impl=impl)
    assert tail.shape == (2, cfg.ssm.d_conv - 1, ssm.mamba_dims(cfg)["conv_dim"])
    assert state.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tail.numpy(), np.asarray(r_tail), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(r_state), atol=ATOL, rtol=RTOL)
    conv, st = tail, state
    r_conv, r_st = r_tail, r_state
    for i in (40, 41):
        r_out, (r_conv, r_st) = ref_ssm.mamba_decode(rp, jnp.asarray(xin[:, i:i + 1]), rcfg,
                                                     BASE_RULES, r_conv, r_st)
        out, (conv, st) = ssm.mamba_decode(p, _t(xin[:, i:i + 1]), cfg, conv, st)
        assert out.shape == (2, 1, cfg.d_model)
        np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(r_conv), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(r_st), atol=ATOL, rtol=RTOL)


def test_prefill_then_decode_equals_longer_prefill(mamba_layer):
    """The O(1) decode carries exactly what a longer prefill computes."""
    _, cfg, _, p = mamba_layer
    xin = _t(np.random.default_rng(8).standard_normal((2, 41, cfg.d_model)).astype(np.float32))
    full, (tail_f, state_f) = ssm.mamba_apply(p, xin, cfg)
    _, (tail, state) = ssm.mamba_apply(p, xin[:, :40], cfg)
    out, (tail_d, state_d) = ssm.mamba_decode(p, xin[:, 40:], cfg, tail, state)
    torch.testing.assert_close(out[:, 0], full[:, 40], atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(tail_d, tail_f, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(state_d, state_f, atol=ATOL, rtol=RTOL)


def test_short_prompt_conv_tail_is_zero_padded(mamba_layer):
    _, cfg, _, p = mamba_layer
    xin = _t(np.random.default_rng(9).standard_normal((1, 2, cfg.d_model)).astype(np.float32))
    _, (tail, _) = ssm.mamba_apply(p, xin, cfg)
    assert tail.shape[1] == cfg.ssm.d_conv - 1
    assert tail[:, 0].eq(0).all() and not tail[:, 1:].eq(0).all()


# ---------------------------------------------------------------------------
# Specs, caches, parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_mamba_specs_match_reference(full):
    rcfg, cfg = ref_get_arch("mamba2-130m"), get_arch("mamba2-130m")
    if not full:
        rcfg, cfg = rcfg.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)

    def leaves(tree):
        return {p: (s.shape, s.axes, s.init, s.scale) for p, s in _leaf_paths(tree)}

    assert leaves(model_spec(cfg)) == leaves(ref_model.model_spec(rcfg))
    assert all(s.dtype is None for _, s in _leaf_paths(model_spec(cfg)))
    assert count_params(model_spec(cfg)) == ref_count_params(ref_model.model_spec(rcfg))
    assert leaves(cache_spec(cfg, 2, 8)) == leaves(ref_model.cache_spec(rcfg, 2, 8))
    # the reference's stacking drops a leaf's dtype; its layer spec holds it,
    # and the port's stacked leaves keep it
    layer = ref_model._layer_cache_spec(rcfg, "mamba", 2, 8, 0)
    for path, spec in _leaf_paths(cache_spec(cfg, 2, 8)):
        assert spec.dtype == layer[path.rsplit("/", 1)[1]].dtype, path
    if full:
        dims = ssm.mamba_dims(cfg)
        assert (cfg.n_layers, cfg.d_model, dims["d_inner"], dims["n_heads"], cfg.ssm.head_dim,
                cfg.ssm.d_state, cfg.ssm.n_groups, cfg.ssm.d_conv, cfg.ssm.chunk, cfg.vocab) == (
            24, 768, 1536, 24, 64, 128, 1, 4, 128, 50280)
        assert 128e6 < count_params(model_spec(cfg)) < 130e6


def test_init_cache_keeps_the_state_in_f32():
    cfg = get_arch("mamba2-130m").reduced()
    cache = init_cache(cfg, 2, 8, device="cpu")         # the parameters' bf16 default
    leaf = cache["0"]["0"]
    dims = ssm.mamba_dims(cfg)
    assert leaf["conv"].dtype == torch.bfloat16
    assert leaf["conv"].shape == (cfg.stages[0].repeats, 2, cfg.ssm.d_conv - 1, dims["conv_dim"])
    assert leaf["state"].dtype == torch.float32
    assert leaf["state"].shape == (cfg.stages[0].repeats, 2, dims["n_heads"], cfg.ssm.head_dim,
                                   cfg.ssm.d_state)
    assert not leaf["state"].any()
