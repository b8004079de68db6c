"""internlm2-1.8b, starcoder2-3b, deepseek-67b and kimi-k2-1t-a32b in the port
vs the reference, at their reduced configs in f32.

Parameters come from the reference's ``init_params`` and cross over by name
(``convert.params_from_jax``); prompts come from ``SyntheticLM`` (numpy,
equal in both).  The reference runs its XLA paths on the CPU (its Pallas
wrappers do not run on the installed JAX): chunked attention, and for AxO
``deploy_axo(impl="xla")``.  Tolerances: exact prefill and decode logits to
``atol=2e-3, rtol=1e-3`` (``tests/test_models_smoke.py``'s), AxO
teacher-forced logits to 1e-3 relative norm along the reference's exact
trajectory (the contract of ``tests/test_torch_serve.py``: a last-ulp
difference in an activation can move one int8 code).  The full-width
configs are checked as data: their widths, spec trees and parameter counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.axo import AxOOperator as RefAxOOperator
from repro.axo import deploy_axo as ref_deploy_axo
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.registry import get_arch as ref_get_arch
from repro.core.operator_model import accurate_config as ref_accurate_config
from repro.core.operator_model import spec_for as ref_spec_for
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models.model import model_spec as ref_model_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import count_params as ref_count_params
from repro.models.spec import init_params as ref_init_params

from repro_torch.axo import AxOOperator, deploy_axo
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import model_spec
from repro_torch.models.spec import _leaf_paths, count_params

ARCHS = ("internlm2-1.8b", "starcoder2-3b", "deepseek-67b", "kimi-k2-1t-a32b")
# (layers, d, heads, kv heads, head width, d_ff, vocab) at full width
FULL = {
    "internlm2-1.8b": (24, 2048, 16, 8, 128, 8192, 92544),
    "starcoder2-3b": (30, 3072, 24, 2, 128, 12288, 49152),
    "deepseek-67b": (95, 8192, 64, 8, 128, 22016, 102400),
    "kimi-k2-1t-a32b": (61, 7168, 64, 8, 112, 18432, 163840),
}
ATOL, RTOL = 2e-3, 1e-3
BATCH, PLEN, GEN = 2, 8, 6
CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mild(accurate, spec_of, cls, rank=16):
    """1-column truncation of the first CC row: ``test_axo_serving._mild_op``."""
    cfg = accurate(spec_of(8))
    cfg[0] = 0
    return cls.from_config(cfg, rank=rank)


def _ref_generate(prefill, decode, params, toks, gen):
    logits, cache = prefill(params, toks)
    nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out, lgs = [nxt], [logits[:, -1]]
    for i in range(PLEN, PLEN + gen - 1):
        logits, cache = decode(params, cache, nxt, jnp.int32(i))
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(nxt)
        lgs.append(logits[:, -1])
    return jnp.concatenate(out, 1), lgs


def _ref_replay(prefill, decode, params, toks, traj):
    logits, cache = prefill(params, toks)
    lgs = [logits[:, -1]]
    for j in range(traj.shape[1] - 1):
        logits, cache = decode(params, cache, traj[:, j:j + 1], jnp.int32(PLEN + j))
        lgs.append(logits[:, -1])
    return lgs


def _np(x) -> np.ndarray:
    return np.array(x)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch: the reference's exact trajectory and logits, its AxO
    deployment and teacher-forced logits; the port's config, parameters from
    the same arrays, prompts and deployment."""
    arch = request.param
    rcfg = ref_get_arch(arch).reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    max_seq = PLEN + GEN
    data = RefSyntheticLM(rcfg, RefShapeConfig("serve", max_seq, BATCH, "train"), seed=0)
    rtoks = jnp.asarray(data.batch(0)["tokens"])[:, :PLEN]
    pre = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq))
    dec = jax.jit(ref_decode_step(rcfg, BASE_RULES))
    traj, exact_lgs = _ref_generate(pre, dec, rparams, rtoks, GEN)
    rdep = ref_deploy_axo(rparams, _mild(ref_accurate_config, ref_spec_for, RefAxOOperator),
                          rcfg, impl="xla")
    pre_a = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq, axo=rdep))
    dec_a = jax.jit(ref_decode_step(rcfg, BASE_RULES, axo=rdep))
    axo_lgs = _ref_replay(pre_a, dec_a, rparams, rtoks, traj)

    cfg = get_arch(arch).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    dep = deploy_axo(params, _mild(accurate_config, spec_for, AxOOperator), cfg, ctx=CPU)
    return {
        "arch": arch, "rcfg": rcfg, "cfg": cfg, "rparams": rparams, "params": params,
        "rdep": rdep, "dep": dep, "max_seq": max_seq,
        "toks": torch.from_numpy(_np(rtoks)).long(),
        "traj": torch.from_numpy(_np(traj)).long(),
        "exact": [torch.from_numpy(_np(x)) for x in exact_lgs],
        "axo": [torch.from_numpy(_np(x)) for x in axo_lgs],
    }


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_spec_and_count_match_reference(arch):
    for full in (False, True):
        rcfg, cfg = ref_get_arch(arch), get_arch(arch)
        if not full:
            rcfg, cfg = rcfg.reduced(), cfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
        want = {p: (s.shape, s.axes, s.init, s.scale)
                for p, s in _leaf_paths(ref_model_spec(rcfg))}
        got = {p: (s.shape, s.axes, s.init, s.scale) for p, s in _leaf_paths(model_spec(cfg))}
        assert got == want
        assert count_params(model_spec(cfg)) == ref_count_params(ref_model_spec(rcfg))
    assert arch in ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_dimensions(arch):
    cfg = get_arch(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab) == FULL[arch]
    assert cfg.resolved_head_dim in HEAD_DIMS      # K7 is built for its prefill
    if arch == "starcoder2-3b":
        assert (cfg.act, cfg.rope_theta, cfg.tie_embeddings) == ("gelu", 100_000.0, False)
    if arch == "kimi-k2-1t-a32b":
        m = cfg.moe
        assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared) == (384, 8, 2048, 1)
        assert [(s.repeats, s.layers) for s in cfg.stages] == [
            (1, (("attn", "dense"),)), (60, (("attn", "moe"),))]
        # kimi at depth 2 (one dense, one moe layer), as chip_smoke.py serves it
        cut = dataclasses.replace(cfg, stages=tuple(dataclasses.replace(s, repeats=1)
                                                    for s in cfg.stages))
        assert abs(count_params(model_spec(cut)) / 1e9 - 19.9) < 0.1


def test_params_from_jax_covers_every_leaf(served):
    s = served
    want = dict(_leaf_paths(jax.tree.map(np.asarray, s["rparams"])))
    got = dict(_leaf_paths(s["params"]))
    assert got.keys() == want.keys() == {p for p, _ in _leaf_paths(model_spec(s["cfg"]))}
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)
    if s["arch"] == "kimi-k2-1t-a32b":
        moe = got.keys() & {f"/stages/1/0/mlp/{w}" for w in
                            ("router", "w_gate", "w_up", "w_down", "shared/w_gate",
                             "shared/w_up", "shared/w_down")}
        assert len(moe) == 7


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_exact_prefill_decode_match_reference(served, impl):
    s = served
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], ctx=ctx)
    dec = make_decode_step(s["cfg"], ctx=ctx)
    traj, lgs, _ = serve.generate(pre, dec, s["params"], s["toks"], GEN)
    assert len(lgs) == GEN
    for step, (a, e) in enumerate(zip(lgs, s["exact"])):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
    assert torch.equal(traj, s["traj"])


def test_axo_teacher_forced_logits_match_reference(served):
    s = served
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], axo=s["dep"], ctx=CPU)
    dec = make_decode_step(s["cfg"], axo=s["dep"], ctx=CPU)
    got = serve.replay(pre, dec, s["params"], s["toks"], s["traj"])
    assert len(got) == GEN
    for step, (a, e) in enumerate(zip(got, s["axo"])):
        assert _rel(a, e) < 1e-3, step
    top1, rel = serve.fidelity(got, s["exact"])
    assert top1 >= 0.5 and rel < 0.5, (top1, rel)


def test_deploy_axo_entries_and_scales_match_reference(served):
    """The same entries as the reference's: ``n_entries``, the tree of entry
    names, and every scale, per expert for a moe layer's banks."""
    s = served
    dep, rdep = s["dep"], s["rdep"]
    assert dep.n_entries == rdep.n_entries
    # one entry a stacked weight: a dense stage's 4 + 2 or 3, a moe stage's 4
    # attention, 3 shared-expert and 3 expert banks; and the head
    dense = 6 if s["cfg"].act == "gelu" else 7
    assert dep.n_entries == 1 + sum(10 if ("attn", "moe") in st.layers else dense
                                    for st in s["cfg"].stages)

    def scales(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) and "scale" in v:
                out[f"{prefix}/{k}"] = np.asarray(v["scale"])
            elif isinstance(v, dict):
                out.update(scales(v, f"{prefix}/{k}"))
        return out

    got, want = scales(dep.stages), scales(rdep.stages)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    np.testing.assert_array_equal(np.asarray(dep.head["scale"]), np.asarray(rdep.head["scale"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_serves_each_arch_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6", "--gen", "3",
                      "--axo-rank", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    cfg = get_arch(arch).reduced()
    assert lines[0].startswith(f"arch={cfg.name} prefill(2x6)=")
    axo = out["axo"]
    assert lines[2].startswith(f"axo rank=4 ({axo['deployment'].n_entries} projections, kernel)")
    assert out["trajectory"].shape == (2, 3) and len(axo["replay_logits"]) == 3
    assert all(torch.isfinite(lg.float()).all() for lg in out["exact_logits"])
    assert np.isfinite(axo["rel_err"])
