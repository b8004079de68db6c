"""jamba-v0.1-52b (hybrid), deepseek-v3-671b (MLA + MoE + MTP), whisper-medium
(encoder-decoder) and llama-3.2-vision-90b (VLM) in the port vs the
reference, at their reduced configs in f32.

Parameters come from the reference's ``init_params`` and cross over by name
(``convert.params_from_jax``); prompts and the stub frontends' embeddings
come from ``SyntheticLM`` (numpy, equal in both).  The reference runs its XLA
paths on the CPU (its Pallas wrappers, but for the SSD scan's, do not run on
the installed JAX): chunked attention, and for AxO ``deploy_axo(impl="xla")``.
Tolerances, as ``tests/test_torch_dense_archs.py``'s: exact prefill and
decode logits to ``atol=2e-3, rtol=1e-3``, AxO teacher-forced logits to
1e-3 relative norm along the reference's exact trajectory -- or, where one
f32 ulp moves the port's own AxO logits by more (an activation code on a
rounding boundary: in whisper's reduced encoder a one-ulp nudge of the norm
weights moves them by 0.0096, as far as they sit from the reference's), to
twice what such a nudge does: whisper alone, as
``chip_smoke.py`` holds mamba2's prefill to twice its plain scan's
rounding.  The full-width
configs are checked as data: their widths, spec trees, parameter counts and
the depth cuts ``chip_smoke.py`` serves.
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
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, NOT_PORTED, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import model_spec
from repro_torch.models.spec import _leaf_paths, count_params

ARCHS = ("jamba-v0.1-52b", "deepseek-v3-671b", "whisper-medium", "llama-3.2-vision-90b")
# (layers, d, heads, kv heads, head width, d_ff, vocab) at full width
FULL = {
    "jamba-v0.1-52b": (32, 4096, 32, 8, 128, 14336, 65536),
    "deepseek-v3-671b": (61, 7168, 128, 128, 56, 18432, 129280),
    "whisper-medium": (24, 1024, 16, 16, 64, 4096, 51865),
    "llama-3.2-vision-90b": (100, 8192, 64, 8, 128, 28672, 128256),
}
# the depth cuts chip_smoke.py serves: stage repeats -> G parameters
CUTS = {"jamba-v0.1-52b": ((1,), 13.27), "deepseek-v3-671b": ((3, 1), 15.21),
        "whisper-medium": ((24,), 0.81), "llama-3.2-vision-90b": ((1,), 6.38)}
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


def _ref_prefill(prefill, params, toks, frontend):
    return prefill(params, toks) if frontend is None else prefill(params, toks, frontend)


def _ref_generate(prefill, decode, params, toks, frontend, gen):
    logits, cache = _ref_prefill(prefill, params, toks, frontend)
    nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out, lgs = [nxt], [logits[:, -1]]
    for i in range(PLEN, PLEN + gen - 1):
        logits, cache = decode(params, cache, nxt, jnp.int32(i))
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(nxt)
        lgs.append(logits[:, -1])
    return jnp.concatenate(out, 1), lgs


def _ref_replay(prefill, decode, params, toks, frontend, traj):
    logits, cache = _ref_prefill(prefill, params, toks, frontend)
    lgs = [logits[:, -1]]
    for j in range(traj.shape[1] - 1):
        logits, cache = decode(params, cache, traj[:, j:j + 1], jnp.int32(PLEN + j))
        lgs.append(logits[:, -1])
    return lgs


def _np(x) -> np.ndarray:
    return np.array(x)


def _frontend(batch: dict):
    for key in ("enc_embeds", "img_embeds"):
        if key in batch:
            return batch[key]
    return None


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch: the reference's exact trajectory and logits, its AxO
    deployment and teacher-forced logits; the port's config, parameters from
    the same arrays, prompts, frontend and deployment."""
    arch = request.param
    rcfg = ref_get_arch(arch).reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    max_seq = PLEN + GEN
    batch = RefSyntheticLM(rcfg, RefShapeConfig("serve", max_seq, BATCH, "train"),
                           seed=0).batch(0)
    rtoks = jnp.asarray(batch["tokens"])[:, :PLEN]
    front = _frontend(batch)
    rfront = None if front is None else jnp.asarray(front)
    pre = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq))
    dec = jax.jit(ref_decode_step(rcfg, BASE_RULES))
    traj, exact_lgs = _ref_generate(pre, dec, rparams, rtoks, rfront, GEN)
    rdep = ref_deploy_axo(rparams, _mild(ref_accurate_config, ref_spec_for, RefAxOOperator),
                          rcfg, impl="xla")
    pre_a = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq, axo=rdep))
    dec_a = jax.jit(ref_decode_step(rcfg, BASE_RULES, axo=rdep))
    axo_lgs = _ref_replay(pre_a, dec_a, rparams, rtoks, rfront, traj)

    cfg = get_arch(arch).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    dep = deploy_axo(params, _mild(accurate_config, spec_for, AxOOperator), cfg, ctx=CPU)
    return {
        "arch": arch, "rcfg": rcfg, "cfg": cfg, "rparams": rparams, "params": params,
        "rdep": rdep, "dep": dep, "max_seq": max_seq,
        "toks": torch.from_numpy(_np(rtoks)).long(),
        "frontend": None if front is None else torch.from_numpy(front),
        "traj": torch.from_numpy(_np(traj)).long(),
        "exact": [torch.from_numpy(_np(x)) for x in exact_lgs],
        "axo": [torch.from_numpy(_np(x)) for x in axo_lgs],
    }


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_every_reference_arch_is_ported():
    from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS

    assert NOT_PORTED == ()
    assert set(ARCH_IDS) == set(REF_ARCH_IDS)
    for arch in ARCHS:
        assert get_arch(arch).name == arch


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


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_dimensions_and_cuts(arch):
    cfg = get_arch(arch)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab) == FULL[arch]
    if arch != "deepseek-v3-671b":            # MLA's attention does not run K7
        assert cfg.resolved_head_dim in HEAD_DIMS
    repeats, g_params = CUTS[arch]
    cut = dataclasses.replace(cfg, stages=tuple(dataclasses.replace(s, repeats=r)
                                                for s, r in zip(cfg.stages, repeats)))
    assert abs(count_params(model_spec(cut)) / 1e9 - g_params) < 0.01
    if arch == "jamba-v0.1-52b":
        (stage,) = cfg.stages
        assert [m for m, _ in stage.layers] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
        assert [f for _, f in stage.layers] == ["dense", "moe"] * 4
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared, cfg.pos_encoding) == (
            16, 2, 0, "none")
        assert (cfg.ssm.head_dim, cfg.ssm.d_state) == (64, 128)
    if arch == "deepseek-v3-671b":
        m = cfg.mla
        assert (m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank, cfg.mtp) == (576, 512, True)
        assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared) == (256, 8, 1)
    if arch == "whisper-medium":
        assert (cfg.encoder.n_layers, cfg.encoder.n_ctx, cfg.act, cfg.pos_encoding) == (
            24, 1500, "gelu", "sinusoid")
    if arch == "llama-3.2-vision-90b":
        assert cfg.n_img_tokens == 1600
        assert [m for m, _ in cfg.stages[0].layers] == ["attn"] * 4 + ["xattn"]


def test_synthetic_frontends_equal_the_reference():
    for arch in ("whisper-medium", "llama-3.2-vision-90b"):
        for cfg, rcfg in ((get_arch(arch).reduced(), ref_get_arch(arch).reduced()),
                          (get_arch(arch), ref_get_arch(arch))):
            got = SyntheticLM(cfg, ShapeConfig("s", 16, 2, "train"), seed=3).batch(1)
            want = RefSyntheticLM(rcfg, RefShapeConfig("s", 16, 2, "train"), seed=3).batch(1)
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{arch} {key}")
    key = {"whisper-medium": "enc_embeds", "llama-3.2-vision-90b": "img_embeds"}
    for arch, k in key.items():
        cfg = get_arch(arch)
        n = cfg.encoder.n_ctx if cfg.encoder else cfg.n_img_tokens
        assert SyntheticLM(cfg, ShapeConfig("s", 4, 1, "train")).batch(0)[k].shape == (
            1, n, cfg.d_model)


def test_params_from_jax_covers_every_leaf(served):
    s = served
    want = dict(_leaf_paths(jax.tree.map(np.asarray, s["rparams"])))
    got = dict(_leaf_paths(s["params"]))
    assert got.keys() == want.keys() == {p for p, _ in _leaf_paths(model_spec(s["cfg"]))}
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)
    extra = {"deepseek-v3-671b": {"/mtp/norm_h", "/mtp/norm_e", "/mtp/proj",
                                  "/stages/0/0/mixer/wkv_b", "/stages/1/0/mixer/wq_a"},
             "whisper-medium": {"/encoder/norm_f", "/encoder/stage/0/mixer/wq",
                                "/stages/0/0/mixer/cross/wk", "/stages/0/0/mixer/norm_x"},
             "llama-3.2-vision-90b": {"/stages/0/4/mixer/gate", "/stages/0/4/mixer/wk"},
             "jamba-v0.1-52b": {"/stages/0/0/mixer/in_proj", "/stages/0/1/mlp/w_gate",
                                "/stages/0/4/mixer/wq"}}[s["arch"]]
    assert extra <= got.keys()


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_exact_prefill_decode_match_reference(served, impl):
    s = served
    ctx = ExecutionContext(device="cpu", kernel_impl=impl)
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], ctx=ctx)
    dec = make_decode_step(s["cfg"], ctx=ctx)
    traj, lgs, _ = serve.generate(pre, dec, s["params"], s["toks"], GEN,
                                  frontend=s["frontend"])
    assert len(lgs) == GEN
    for step, (a, e) in enumerate(zip(lgs, s["exact"])):
        np.testing.assert_allclose(a.numpy(), e.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
    assert torch.equal(traj, s["traj"])


def _nudged(params: dict, seed: int) -> dict:
    """``params`` with every norm weight moved one f32 ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not name.startswith("norm"):
            return tree
        sign = (torch.randint(0, 2, tree.shape, generator=gen) * 2 - 1).to(tree.dtype)
        return torch.nextafter(tree, tree + sign)

    return walk(params)


def test_axo_teacher_forced_logits_match_reference(served):
    s = served
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], axo=s["dep"], ctx=CPU)
    dec = make_decode_step(s["cfg"], axo=s["dep"], ctx=CPU)
    got = serve.replay(pre, dec, s["params"], s["toks"], s["traj"], s["frontend"])
    assert len(got) == GEN
    limit = spread = 1e-3
    if s["arch"] == "whisper-medium":
        # the port's own spread under one-ulp nudges of its norm weights
        spread = max(max(_rel(a, b) for a, b in zip(
            serve.replay(pre, dec, _nudged(s["params"], seed), s["toks"], s["traj"],
                         s["frontend"]), got)) for seed in range(4))
        limit = max(1e-3, 2 * spread)
    for step, (a, e) in enumerate(zip(got, s["axo"])):
        assert _rel(a, e) < limit, (step, spread)


def _entries(tree, prefix=""):
    """{path: scale} of every entry of a deployment's tree."""
    out = {}
    for k, v in (tree or {}).items():
        if isinstance(v, dict) and "scale" in v:
            out[f"{prefix}/{k}"] = np.asarray(v["scale"])
        elif isinstance(v, dict):
            out.update(_entries(v, f"{prefix}/{k}"))
    return out


def test_deploy_axo_entries_and_scales_match_reference(served):
    """The reference's entries: ``n_entries``, the tree of entry names (MLA's
    four without ``wkv_b``, ``attn_x``'s self and cross halves, the encoder
    stage, a mamba layer's MLP) and every scale, per expert for a moe bank."""
    s = served
    dep, rdep = s["dep"], s["rdep"]
    assert dep.n_entries == rdep.n_entries
    for part in ("stages", "encoder"):
        got, want = _entries(getattr(dep, part)), _entries(getattr(rdep, part))
        assert got.keys() == want.keys(), part
        for path in want:
            np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    np.testing.assert_array_equal(np.asarray(dep.head["scale"]), np.asarray(rdep.head["scale"]))
    names = set(_entries(dep.stages))
    if s["arch"] == "deepseek-v3-671b":
        assert {"/0/0/mixer/wq_a", "/0/0/mixer/wq_b", "/0/0/mixer/wkv_a",
                "/0/0/mixer/wo"} <= names
        assert not any("wkv_b" in n for n in names)
        assert "/1/0/mlp/experts/w_gate" in names and "/1/0/mlp/shared/w_up" in names
    if s["arch"] == "jamba-v0.1-52b":
        assert "/0/0/mlp/w_gate" in names and "/0/1/mlp/experts/w_down" in names
        assert not any(n.startswith(("/0/0/mixer", "/0/1/mixer")) for n in names)
    if s["arch"] == "whisper-medium":
        assert {"/0/0/mixer/self/wq", "/0/0/mixer/cross/wv"} <= names
        assert set(_entries(dep.encoder)) == {"/0/mixer/wq", "/0/mixer/wk", "/0/mixer/wv",
                                              "/0/mixer/wo", "/0/mlp/w_up", "/0/mlp/w_down"}
    else:
        assert dep.encoder is None


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
    has_frontend = cfg.encoder is not None or cfg.n_img_tokens > 0
    assert (out["frontend"] is not None) == has_frontend
