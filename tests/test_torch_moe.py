"""The port's MoE layer (``models/moe.py``) and its AxO expert entries vs the
reference, at reduced kimi-k2-1t-a32b in f32.

Weights come from the reference's ``init_params`` and cross over by name
(``convert.params_from_jax``); activations are made from a seed with numpy.
The reference runs its single-device path on the CPU: ``_dispatch_compute``
with its einsum experts, or, with an ``AxODeployment`` built by
``deploy_axo(impl="xla")``, its per-expert loop on the XLA contraction.
Tolerances: the exact dispatch, ``moe_apply``'s output and its aux loss to
1e-5 relative norm (f32; the two sum the same products in another order).
The AxO dispatch is held to the same 1e-5: both quantize the same f32
buffers, and the second quantization (of the silu-gated hidden) sees
values that agree to f32 rounding.
"""

import dataclasses
import math

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
from repro.models.model import model_spec as ref_model_spec
from repro.models.moe import _dispatch_compute as ref_dispatch
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_capacity as ref_moe_capacity
from repro.models.sharding import BASE_RULES
from repro.models.spec import init_params as ref_init_params

from repro_torch.axo import AxOOperator, deploy_axo
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.models.model import _at, model_spec
from repro_torch.models.moe import _dispatch_compute, moe_apply, moe_capacity, moe_spec
from repro_torch.models.spec import _leaf_paths, _path_seed, init_params

REL = 1e-5
CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _mild(accurate, spec_of, cls, rank=16):
    """1-column truncation of the first CC row: ``test_axo_serving._mild_op``."""
    cfg = accurate(spec_of(8))
    cfg[0] = 0
    return cls.from_config(cfg, rank=rank)


@pytest.fixture(scope="module")
def kimi():
    """Reduced kimi in f32: configs, reference params, the port's copy, and
    both AxO deployments of the mild operator."""
    rcfg = ref_get_arch("kimi-k2-1t-a32b").reduced()
    cfg = get_arch("kimi-k2-1t-a32b").reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rdep = ref_deploy_axo(rparams, _mild(ref_accurate_config, ref_spec_for, RefAxOOperator),
                          rcfg, impl="xla")
    dep = deploy_axo(params, _mild(accurate_config, spec_for, AxOOperator), cfg, ctx=CPU)
    return rcfg, cfg, rparams, params, rdep, dep


def _moe_layer(rparams, params, r=0):
    """Repeat ``r`` of the moe stage's layer: the reference's and the port's params."""
    rp = jax.tree.map(lambda t: t[r], rparams["stages"]["1"]["0"]["mlp"])
    return rp, _at(params["stages"]["1"]["0"]["mlp"], r)


def _routing(seed, t, k, n_experts, skew=None):
    """Distinct expert ids per token (as top-k gives them) and positive gates;
    ``skew`` sends every token's first slot to that expert."""
    rng = np.random.default_rng(seed)
    top_i = np.stack([rng.permutation(n_experts)[:k] for _ in range(t)]).astype(np.int32)
    if skew is not None:
        for row in top_i:
            j = int(np.flatnonzero(row == skew)[0]) if skew in row else 0
            row[[0, j]] = row[[j, 0]]
            row[0] = skew
    gates = rng.uniform(0.1, 1.0, (t, k)).astype(np.float32)
    return top_i, gates / gates.sum(-1, keepdims=True)


def _ref_expert_entries(rdep, r=0):
    return jax.tree.map(lambda t: t[r], rdep.stages["1"]["0"]["mlp"]["experts"])


def test_moe_spec_and_capacity_match_reference(kimi):
    rcfg, cfg = kimi[0], kimi[1]
    from repro.models.moe import moe_spec as ref_moe_spec

    for full in (False, True):
        rc = ref_get_arch("kimi-k2-1t-a32b") if full else rcfg
        c = get_arch("kimi-k2-1t-a32b") if full else cfg
        want = {p: (s.shape, s.axes, s.init, s.scale) for p, s in _leaf_paths(ref_moe_spec(rc))}
        got = {p: (s.shape, s.axes, s.init, s.scale) for p, s in _leaf_paths(moe_spec(c))}
        assert got == want
        for t in (1, 4, 16, 100, 512, 4096):
            assert moe_capacity(t, c) == ref_moe_capacity(t, rc), t


@pytest.mark.parametrize("t, cap, e0, e_loc, skew", [
    (16, None, 0, 8, None),      # the layer's own capacity (8): nothing dropped
    (16, 2, 0, 8, None),         # 2 slots an expert: entries dropped
    (40, 8, 0, 8, 3),            # every token's first slot to expert 3: 40 for 8 slots
    (24, 4, 4, 4, None),         # experts 4..7 held here: the rest go to the sentinel
])
def test_dispatch_matches_reference(kimi, t, cap, e0, e_loc, skew):
    rcfg, cfg, rparams, params = kimi[:4]
    rp, p = _moe_layer(rparams, params)
    k, n_exp = cfg.moe.top_k, cfg.moe.n_experts
    cap = moe_capacity(t, cfg) if cap is None else cap
    x = np.random.default_rng(t).standard_normal((t, cfg.d_model)).astype(np.float32)
    top_i, gates = _routing(t + cap, t, k, n_exp, skew)
    local = (top_i >= e0) & (top_i < e0 + e_loc)
    loads = np.bincount(top_i[local].ravel() - e0, minlength=e_loc)
    if cap < moe_capacity(t, cfg):
        assert loads.max() > cap            # the case drops entries
    banks = [slice(e0, e0 + e_loc)]
    want = ref_dispatch(jnp.asarray(x), jnp.asarray(top_i), jnp.asarray(gates),
                        *(rp[w][tuple(banks)] for w in ("w_gate", "w_up", "w_down")), e0, cap)
    got = _dispatch_compute(torch.from_numpy(x), torch.from_numpy(top_i),
                            torch.from_numpy(gates),
                            *(p[w][tuple(banks)] for w in ("w_gate", "w_up", "w_down")), e0, cap)
    assert got.shape == (t, cfg.d_model)
    assert _rel(got.numpy(), np.asarray(want)) < REL
    # a token whose every entry was dropped gets exactly 0
    dropped = np.ones(t, bool)
    order = np.argsort(np.where(local, top_i - e0, e_loc).ravel(), kind="stable")
    seen = np.zeros(e_loc, int)
    for flat in order:
        e = int(top_i.ravel()[flat]) - e0
        if 0 <= e < e_loc:
            if seen[e] < cap:
                dropped[flat // k] = False
            seen[e] += 1
    assert np.all(got.numpy()[dropped] == 0)


@pytest.mark.parametrize("t, cap", [(16, 8), (40, 4)])
def test_axo_dispatch_matches_reference(kimi, t, cap):
    """The AxO experts: a Python loop over the experts, each (cap, d) buffer
    through the deployment; the second case drops entries."""
    rcfg, cfg, rparams, params, rdep, dep = kimi
    rp, p = _moe_layer(rparams, params)
    x = np.random.default_rng(t).standard_normal((t, cfg.d_model)).astype(np.float32)
    top_i, gates = _routing(t, t, cfg.moe.top_k, cfg.moe.n_experts, skew=1 if t > 16 else None)
    want = ref_dispatch(jnp.asarray(x), jnp.asarray(top_i), jnp.asarray(gates),
                        rp["w_gate"], rp["w_up"], rp["w_down"], 0, cap,
                        axo=(rdep, _ref_expert_entries(rdep)))
    ent = _at(dep.stages["1"]["0"]["mlp"]["experts"], 0)
    got = _dispatch_compute(torch.from_numpy(x), torch.from_numpy(top_i),
                            torch.from_numpy(gates), p["w_gate"], p["w_up"], p["w_down"],
                            0, cap, axo=(dep, ent))
    assert _rel(got.numpy(), np.asarray(want)) < REL
    exact = _dispatch_compute(torch.from_numpy(x), torch.from_numpy(top_i),
                              torch.from_numpy(gates), p["w_gate"], p["w_up"], p["w_down"],
                              0, cap)
    assert 0 < _rel(got.numpy(), exact.numpy()) < 0.5


@pytest.mark.parametrize("b, s, capacity_factor, axo", [
    (2, 8, None, False), (2, 8, None, True),
    (2, 64, 0.25, False), (2, 64, 0.25, True),   # 128 tokens: capacity 8 for a mean load of 32
])
def test_moe_apply_matches_reference(kimi, b, s, capacity_factor, axo):
    rcfg, cfg, rparams, params, rdep, dep = kimi
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    rp, p = _moe_layer(rparams, params)
    x = np.random.default_rng(b * s).standard_normal((b, s, cfg.d_model)).astype(np.float32)
    r_axo = (rdep, jax.tree.map(lambda t: t[0], rdep.stages["1"]["0"]["mlp"])) if axo else None
    p_axo = (dep, _at(dep.stages["1"]["0"]["mlp"], 0)) if axo else None
    want, want_aux = ref_moe_apply(rp, jnp.asarray(x), rcfg, BASE_RULES, axo=r_axo)
    got, aux = moe_apply(p, torch.from_numpy(x), cfg, axo=p_axo)
    assert got.shape == (b, s, cfg.d_model) and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert _rel(got.numpy(), np.asarray(want)) < REL
    assert abs(float(aux) - float(want_aux)) <= REL * abs(float(want_aux))
    if capacity_factor is not None:     # the router's loads overflow the capacity
        logits = x.reshape(b * s, -1) @ rp["router"]
        top = np.argsort(-logits, -1)[:, :cfg.moe.top_k]
        assert np.bincount(top.ravel()).max() > moe_capacity(b * s, cfg)


def test_deploy_axo_expert_entries_match_reference(kimi):
    """``"moe"`` deploys one entry per (repeat, expert), each expert with its
    own scale; ``"mlp"`` the shared expert; the router stays exact;
    ``n_entries`` counts as the reference does (one per stacked weight)."""
    rcfg, cfg, rparams, params, rdep, dep = kimi
    assert dep.n_entries == rdep.n_entries == 18
    ent, rent = dep.stages["1"]["0"]["mlp"], rdep.stages["1"]["0"]["mlp"]
    assert set(ent) == set(rent) == {"experts", "shared"}
    reps, n_exp = cfg.stages[1].repeats, cfg.moe.n_experts
    sv = np.asarray(dep.signed_vals)
    for w in ("w_gate", "w_up", "w_down"):
        codes, scale = ent["experts"][w]["codes"], ent["experts"][w]["scale"]
        assert codes.dtype == torch.uint8 and codes.shape == params["stages"]["1"]["0"]["mlp"][w].shape
        assert scale.shape == (reps, n_exp)
        np.testing.assert_array_equal(scale.numpy(), np.asarray(rent["experts"][w]["scale"]))
        # the reference caches each expert's signed values; the port its codes
        np.testing.assert_array_equal(sv[codes.numpy()], np.asarray(rent["experts"][w]["bv"]))
        # expert by expert equals quantizing each expert's matrix on its own
        from repro_torch.axo import quantize_tensor

        for r in range(reps):
            for e in range(n_exp):
                q, sc = quantize_tensor(params["stages"]["1"]["0"]["mlp"][w][r, e])
                assert torch.equal(codes[r, e], q.to(torch.uint8)) and float(sc) == float(
                    scale[r, e])
        np.testing.assert_array_equal(ent["shared"][w]["scale"].numpy(),
                                      np.asarray(rent["shared"][w]["scale"]))
    assert "router" not in ent["experts"] and "router" not in ent["shared"]
    only_moe = deploy_axo(params, dep.op, cfg, layers=("moe",), ctx=CPU)
    assert set(only_moe.stages["1"]["0"]["mlp"]) == {"experts"}
    assert only_moe.stages["0"]["0"] == {} and only_moe.head is None
    assert only_moe.n_entries == 3 == ref_deploy_axo(rparams, rdep.op, rcfg, layers=("moe",),
                                                     impl="xla").n_entries


def test_init_params_sliced_draws_keep_the_values():
    """``init_params`` draws a leaf of more than two axes one (K, N) matrix at
    a time; on the CPU that gives one ``torch.randn`` of the whole leaf from
    its generator bit for bit, shown here at the reduced kimi, in f32 and
    cast to bf16."""
    cfg = get_arch("kimi-k2-1t-a32b").reduced()
    tree = model_spec(cfg)
    f32 = dict(_leaf_paths(init_params(tree, seed=5, dtype=torch.float32, device="cpu")))
    bf16 = dict(_leaf_paths(init_params(tree, seed=5, device="cpu")))
    n_sliced = 0
    for path, sp in _leaf_paths(tree):
        if sp.init != "normal" or len(sp.shape) <= 2:
            continue
        gen = torch.Generator().manual_seed(_path_seed(path, 5))
        whole = torch.randn(sp.shape, generator=gen) * (sp.scale / math.sqrt(sp.shape[-2]))
        assert torch.equal(whole, f32[path]), path
        assert torch.equal(whole.to(torch.bfloat16), bf16[path]), path
        n_sliced += 1
    assert n_sliced >= 12      # the banks, the router and attention, in both stages


@pytest.mark.parametrize("block", [1, 7, 64 * 5, 1 << 26])
def test_quantize_weight_in_blocks_keeps_the_codes(block, monkeypatch):
    """``deploy_axo`` quantizes each weight in row blocks (the head's f32
    copy would not fit beside kimi-k2 on the card): the codes and scale equal
    ``quantize_tensor`` of the whole weight, in f32 and from bf16."""
    from repro_torch.axo import deploy, quantize_tensor, quantize_weight

    monkeypatch.setattr(deploy, "QUANT_BLOCK", block)
    w = torch.from_numpy(np.random.default_rng(block).standard_normal((37, 64)).astype(
        np.float32))
    for x in (w, w.to(torch.bfloat16)):
        codes, scale = quantize_weight(x)
        q, sc = quantize_tensor(x.to(torch.float32))
        assert codes.dtype == torch.uint8 and torch.equal(codes, q.to(torch.uint8))
        assert float(scale) == float(sc)


def test_moe_layers_sum_their_aux_loss(kimi):
    """``forward`` returns the moe layers' aux losses summed (the reference's
    ``_run_stage``), and a dense model 0."""
    from repro.models.model import forward as ref_forward
    from repro_torch.models.model import forward

    rcfg, cfg, rparams, params = kimi[:4]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    _, want, _ = ref_forward(rparams, rcfg, BASE_RULES, jnp.asarray(toks), mode="train")
    _, aux, _ = forward(params, cfg, torch.from_numpy(toks).long(), mode="train")
    assert float(want) > 0
    assert abs(float(aux) - float(want)) <= REL * float(want)
