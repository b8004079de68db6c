"""The port's AxO operator, quantization, K6's plain version and AxO layers vs
the reference.

The reference's Pallas wrappers do not run on the installed JAX, so the port
is held against its CPU paths: ``ref.ref_axo_matmul_lowrank``,
``axo_linear(..., use_kernel=False)`` and ``deploy_axo(..., impl="xla")``.
Inputs are made from a seed with numpy and handed to both packages.  f32
results are compared by relative norm, ``||got - want|| / ||want|| < 1e-5``
(the reference's ``axo_matmul`` tolerance): the two sum the same products in
another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.axo import AxOOperator as RefAxOOperator
from repro.axo import axo_linear as ref_axo_linear
from repro.axo import deploy_axo as ref_deploy_axo
from repro.axo import quantize_tensor as ref_quantize_tensor
from repro.configs.registry import get_arch as ref_get_arch
from repro.core.operator_model import accurate_config as ref_accurate_config
from repro.core.operator_model import spec_for as ref_spec_for
from repro.kernels.ref import ref_axo_matmul_lowrank
from repro.models.model import model_spec as ref_model_spec
from repro.models.spec import init_params as ref_init_params

from repro_torch.axo import AXO_LAYERS, AxOOperator, axo_linear, deploy_axo, quantize_tensor
from repro_torch.configs.registry import get_arch
from repro_torch.convert import from_state, params_from_jax, state_of
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.kernels import axo_matmul as k6

REL = 1e-5
CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mild_config(accurate, spec):
    """1-column truncation of the first CC row (``tests/test_axo_serving.py``'s)."""
    cfg = accurate(spec)
    cfg[0] = 0
    return cfg


@pytest.fixture(scope="module")
def ops():
    """rank -> (reference operator, port operator) for the mild design."""
    out = {}
    for rank in (1, 8, 16):
        ref = RefAxOOperator.from_config(_mild_config(ref_accurate_config, ref_spec_for(8)),
                                         rank=rank)
        out[rank] = ref, AxOOperator.from_config(
            _mild_config(accurate_config, spec_for(8)), rank=rank)
    return out


@pytest.fixture(scope="module")
def granite():
    rcfg = ref_get_arch("granite-3-2b").reduced()
    cfg = get_arch("granite-3-2b").reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    return rcfg, cfg, rparams, params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                                               device="cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tables(op):
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32))
                 for t in (op.f_table, op.g_table, op.signed_vals))


def test_operator_arrays_equal_reference(ops):
    for rank, (ref, op) in ops.items():
        assert (op.n_bits, op.rank) == (ref.n_bits, ref.rank) == (8, rank)
        for name in ("f_table", "g_table", "signed_vals", "table"):
            np.testing.assert_array_equal(getattr(op, name), getattr(ref, name), err_msg=name)
        np.testing.assert_array_equal(op.rank_table(), ref.rank_table())
        assert op.rank_behav() == ref.rank_behav()
    # carried across by its arrays
    ref = ops[8][0]
    again = from_state(state_of(ref))
    assert isinstance(again, AxOOperator) and again.rank == 8
    np.testing.assert_array_equal(again.f_table, ref.f_table)
    np.testing.assert_array_equal(again.table, ref.table)


@pytest.mark.parametrize("shape", [(37, 45), (4, 2048), (1, 3)])
def test_quantize_tensor_matches_reference(shape):
    x = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32) * 3
    x.flat[0] = -np.abs(x).max() * 1.5          # the clip at -qmax - 1 stays unhit
    want_q, want_s = ref_quantize_tensor(jnp.asarray(x))
    got_q, got_s = quantize_tensor(torch.from_numpy(x))
    assert got_q.dtype == torch.int32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_max_ulp(got_s.numpy(), np.asarray(want_s), maxulp=1)
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])   # half to even, as jnp.round
    np.testing.assert_array_equal(quantize_tensor(half)[0].numpy(),
                                  np.asarray(ref_quantize_tensor(jnp.asarray(half.numpy()))[0]))


@pytest.mark.parametrize("rank", [1, 8, 16])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_k6_plain_matches_reference(ops, rank, m):
    ref = ops[rank][0]
    rng = np.random.default_rng(m * 100 + rank)
    k, n = 45, 29                                         # ragged K and N
    a = rng.integers(0, 256, (m, k)).astype(np.int32)
    b = rng.integers(0, 256, (k, n)).astype(np.int32)
    want = ref_axo_matmul_lowrank(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ref.f_table),
                                  jnp.asarray(ref.g_table),
                                  jnp.asarray(ref.signed_vals, jnp.float32))
    f, g, sv = _tables(ops[rank][1])
    at, bt = torch.from_numpy(a).to(torch.uint8), torch.from_numpy(b).to(torch.uint8)
    got = k6.axo_matmul_plain(at, bt, f, g, sv)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < REL
    before = k6.axo_matmul.launches
    assert torch.equal(k6.axo_matmul(at, bt, f, g, sv), got)   # CPU: the plain version
    assert k6.axo_matmul.launches == before


def test_k6_wrapper_checks_and_plans(ops):
    f, g, sv = _tables(ops[8][1])
    a = torch.zeros((4, 16), dtype=torch.uint8)
    b = torch.zeros((16, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        k6.axo_matmul(a.int(), b, f, g, sv)
    with pytest.raises(ValueError, match="disagree"):
        k6.axo_matmul(a, b[:15], f, g, sv)
    with pytest.raises(ValueError, match="2\\^n"):
        k6.axo_matmul(a, b, f[:100].contiguous(), g[:100].contiguous(), sv[:100].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        k6.axo_matmul(a, torch.zeros((8, 16), dtype=torch.uint8).T, f, g, sv)
    # decode shapes take the small-M route (8-row blocks) and split K until
    # the grid fills a wave; prefill takes the tensor cores (the wgmma route
    # from 512 rows) and does not split; granite's wide head keeps the GEMV
    pl = k6.plan(4, 2048, 2048, 8, 256)
    assert pl[:4] == ("small", 8, 32, 64) and pl.splits * pl.k_split >= 2048
    assert k6.plan(512, 8192, 2048, 8, 256)[:3] == ("wgmma", 128, 1)
    assert k6.plan(4, 49155, 2048, 8, 256)[:3] == ("gemv", 4, 8)
    pl2 = k6.plan(4, 2048, 8192, 8, 256)
    assert pl2.k_split % 32 == 0
    assert (pl2.splits - 1) * pl2.k_split < 8192 <= pl2.splits * pl2.k_split
    assert pl.smem <= k6.MAX_SMEM and k6.plan(4, 64, 64, 16, 256).smem <= k6.MAX_SMEM


@pytest.mark.parametrize("lead", [(6,), (2, 5)])
def test_axo_linear_matches_reference(ops, lead):
    ref, op = ops[8]
    rng = np.random.default_rng(len(lead))
    x = rng.standard_normal((*lead, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 40)) / 8).astype(np.float32)
    want = ref_axo_linear(jnp.asarray(x), jnp.asarray(w), ref, use_kernel=False)
    for use_kernel in (True, False):
        got = axo_linear(torch.from_numpy(x), torch.from_numpy(w), op, use_kernel=use_kernel)
        assert got.shape == (*lead, 40)
        assert _rel(got.numpy(), want) < REL
    plain = axo_linear(torch.from_numpy(x), torch.from_numpy(w), op,
                       ctx=ExecutionContext(device="cpu", kernel_impl="plain"))
    assert _rel(plain.numpy(), want) < REL


def test_deploy_entry_counts_and_validation(granite, ops):
    _, cfg, _, params = granite
    op = ops[1][1]
    assert deploy_axo(params, op, cfg).n_entries == 8
    assert deploy_axo(params, op, cfg, layers=("head",)).n_entries == 1
    assert deploy_axo(params, op, cfg, layers=("attn",)).n_entries == 4
    with pytest.raises(ValueError, match="unknown AxO layer"):
        deploy_axo(params, op, cfg, layers=("attn", "lstm"))
    dep = deploy_axo(params, op, cfg, layers=AXO_LAYERS, ctx=CPU)
    ent = dep.stages["0"]["0"]["mixer"]["wq"]
    rep, d = cfg.stages[0].repeats, cfg.d_model
    assert ent["codes"].shape == (rep, d, cfg.n_heads * cfg.resolved_head_dim)
    assert ent["codes"].dtype == torch.uint8 and ent["scale"].shape == (rep,)
    assert dep.head["codes"].shape == (d, cfg.vocab) and dep.impl == "kernel"
    plain = dataclasses.replace(dep, ctx=ExecutionContext(device="cpu", kernel_impl="plain"))
    assert plain.impl == "plain" and plain.head is dep.head


def test_deployment_apply_matches_reference(granite, ops):
    """Every cached entry (the head and each stacked layer's projections) on
    the same converted weights, against the reference's ``impl="xla"``."""
    rcfg, cfg, rparams, params = granite
    ref, op = ops[16]
    rdep = ref_deploy_axo(rparams, ref, rcfg, impl="xla")
    dep = deploy_axo(params, op, cfg, ctx=CPU)
    rng = np.random.default_rng(7)

    def check(rent, ent):
        k = ent["codes"].shape[-2]
        x = rng.standard_normal((2, 5, k)).astype(np.float32)
        want = rdep.apply(jnp.asarray(x), rent)
        got = dep.apply(torch.from_numpy(x), ent)
        assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
        assert _rel(got.numpy(), want) < REL

    check(rdep.head, dep.head)
    np.testing.assert_allclose(float(dep.head["scale"]), float(rdep.head["scale"]), rtol=1e-7)
    for r in range(cfg.stages[0].repeats):
        for part, names in (("mixer", ("wq", "wk", "wv", "wo")),
                            ("mlp", ("w_gate", "w_up", "w_down"))):
            for name in names:
                rent = jax.tree.map(lambda t: t[r], rdep.stages["0"]["0"][part][name])
                ent = {k: v[r] for k, v in dep.stages["0"]["0"][part][name].items()}
                check(rent, ent)
