"""Training in the port (``compute_loss``, ``make_train_step``, the autograd
paths of K7 and K8) against the reference, at the reduced configs in f32.

Parameters come from the reference's ``init_params`` and cross over by name
(``convert.params_from_jax``); batches come from ``SyntheticLM`` (numpy,
equal in both).  The reference runs its XLA paths on the CPU (chunked
attention, ``ssd_chunked``); the port runs its blockwise attention there
(``models.attention.chunked_attention``, the reference's chunks) and K8's
plain version, through ``SSDScanFn`` where a gradient is wanted.
``FlashAttentionFn``'s forward is K7's plain version on the CPU and its
backward the blockwise one.

Tolerances: the loss and its parts to 1e-5 relative.  Gradients per leaf to
1e-4 relative norm (a leaf whose norm is under 1e-6 of the global norm is
judged against the global norm) -- or, where the reference's own gradients
are that sensitive, to twice what one-ulp nudges of the weights do, the
smaller of their effect on the reference's gradients and on the port's: with
random weights some reduced archs' attention saturates, and a one-ulp nudge
moves the reference's gradients of llama-3.2-vision-90b by ~8e-3, of
jamba-v0.1-52b and kimi-k2-1t-a32b by ~3e-4, as far as the port sits from
the reference (both nudges are measured in each such test and printed).  A full
train step: loss to 1e-5, ``grad_norm`` to 1e-4, parameters and optimizer
state to 1e-5 relative norm (at step 0 AdamW's update is about lr * sign(g),
so an element whose gradient is near zero may move by 2 lr in one package
and not the other; those are few).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.ckpt import _flatten_with_paths
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.registry import get_arch as ref_get_arch
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.model import compute_loss as ref_compute_loss
from repro.models.model import model_spec as ref_model_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import init_params as ref_init_params
from repro.optim import cosine_schedule as ref_cosine_schedule
from repro.optim import make_optimizer as ref_make_optimizer

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn, blockwise_attention, flash_attention_plain,
)
from repro_torch.kernels.ssd_scan import SSDScanFn, ssd_scan_plain
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import compute_loss, forward, model_spec
from repro_torch.models.spec import init_params
from repro_torch.optim import cosine_schedule, make_optimizer, tree_leaves, tree_map
from repro_torch.launch.steps import init_cache

ARCHS = sorted(ARCH_IDS)
BATCH, SEQ = 2, 32
CPU = ExecutionContext(device="cpu")
GRAD_REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The port's CPU tensors here are small: many intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _port_batch(batch: dict) -> dict:
    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's f32 params, batch, loss, metrics and gradients."""
    rcfg = ref_get_arch(arch).reduced()
    params = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    batch = RefSyntheticLM(rcfg, RefShapeConfig("t", SEQ, BATCH, "train"), seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: ref_compute_loss(p, rcfg, BASE_RULES, jb), has_aux=True)(params)
    return {"params": _np_tree(params), "batch": batch, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": dict(_flatten_with_paths(_np_tree(grads)))}


def _port_grads(params: dict, cfg, batch: dict):
    """(loss, metrics, {path: grad}) of the port's ``compute_loss``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = compute_loss(leaves, cfg, batch, ctx=CPU)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    paths = [p for p, _ in _flatten_with_paths(params)]
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            {p: (torch.zeros_like(x) if g is None else g).numpy()
             for p, x, g in zip(paths, flat, grads)})


def _worst_leaf(got: dict, want: dict) -> tuple[float, str]:
    """The largest per-leaf relative norm; a leaf under 1e-6 of the global
    norm is judged against the global norm."""
    gn = np.sqrt(sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want.values()))
    worst = (0.0, "")
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[path], np.float64) - w)
        worst = max(worst, (d / max(np.linalg.norm(w), 1e-6 * gn), path))
    return worst


def _nudged(params: dict, seed: int, names: str | None) -> dict:
    """``params`` with every leaf (or those whose name starts with ``names``)
    moved one f32 ulp up or down at random."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if names is not None and not name.startswith(names):
            return tree
        sign = torch.randint(0, 2, tree.shape, generator=gen) * 2 - 1
        return torch.nextafter(tree, tree + sign.to(tree.dtype))

    return walk(params)


def _ref_nudged_grads(arch: str, seed: int, names: str | None) -> dict:
    """The reference's gradients, ``{path: grad}``, from its params with
    every leaf (or those whose name starts with ``names``) moved one f32 ulp
    up or down at random."""
    ref = _reference(arch)
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if names is not None and not name.startswith(names):
            return tree
        sign = (rng.integers(0, 2, np.shape(tree)) * 2 - 1).astype(tree.dtype)
        return jnp.asarray(np.nextafter(tree, tree + sign))

    rcfg = ref_get_arch(arch).reduced()
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    _, grads = jax.value_and_grad(lambda p: ref_compute_loss(p, rcfg, BASE_RULES, jb),
                                  has_aux=True)(walk(ref["params"]))
    return dict(_flatten_with_paths(_np_tree(grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    ref = _reference(arch)
    cfg = get_arch(arch).reduced()
    params = params_from_jax(ref["params"], cfg, device="cpu")
    loss, metrics = compute_loss(params, cfg, _port_batch(ref["batch"]), ctx=CPU)
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)
    assert set(metrics) == set(ref["metrics"])
    assert ("mtp_ce" in metrics) == cfg.mtp
    for k, want in ref["metrics"].items():
        assert float(metrics[k]) == pytest.approx(want, rel=1e-5, abs=1e-7), k
    assert (float(metrics["moe_aux"]) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch):
    """Every leaf's gradient, MoE dispatch (the capacity scatter passes
    gradients to the routed entries only, as the reference's ``mode="drop"``
    scatter does), K7's and K8's autograd paths and the MTP head included."""
    ref = _reference(arch)
    cfg = get_arch(arch).reduced()
    params = params_from_jax(ref["params"], cfg, device="cpu")
    batch = _port_batch(ref["batch"])
    _, _, grads = _port_grads(params, cfg, batch)
    assert set(grads) == set(ref["grads"])
    worst, where = _worst_leaf(grads, ref["grads"])
    limit = GRAD_REL
    if worst > GRAD_REL:
        nudges = ((0, "norm"), (1, None))
        ref_spread = max(_worst_leaf(_ref_nudged_grads(arch, seed, names), ref["grads"])[0]
                         for seed, names in nudges)
        port_spread = max(_worst_leaf(_port_grads(_nudged(params, seed, names), cfg, batch)[2],
                                      grads)[0] for seed, names in nudges)
        limit = max(GRAD_REL, 2 * min(ref_spread, port_spread))
        print(f"{arch}: one-ulp nudges move the reference's gradients by {ref_spread:.3g}, "
              f"the port's by {port_spread:.3g}")
    print(f"{arch}: worst leaf {where} {worst:.3g}; limit {limit:.3g}")
    assert worst <= limit, (where, worst, limit)


def _ref_train(arch, steps, accum=1, int8=False, lr=1e-3):
    """The reference's jitted train step over ``steps`` steps from the f32
    params of ``_reference``: (metrics a step, params, opt state)."""
    ref = _reference(arch)
    rcfg = ref_get_arch(arch).reduced()
    opt = ref_make_optimizer(rcfg.optimizer, ref_cosine_schedule(lr, warmup_steps=1,
                                                                 total_steps=10))
    fn = jax.jit(ref_make_train_step(rcfg, BASE_RULES, opt, accum_steps=accum,
                                     int8_accum=int8))
    params = jax.tree.map(jnp.asarray, ref["params"])
    state = opt.init(params)
    jb = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    seen = []
    for t in range(steps):
        params, state, metrics = fn(params, state, jnp.int32(t), jb)
        seen.append({k: float(v) for k, v in metrics.items()})
    return seen, _np_tree(params), _np_tree(state)


def _port_train(arch, steps, accum=1, int8=False, lr=1e-3):
    ref = _reference(arch)
    cfg = get_arch(arch).reduced()
    opt = make_optimizer(cfg.optimizer, cosine_schedule(lr, warmup_steps=1, total_steps=10))
    fn = make_train_step(cfg, opt, accum_steps=accum, int8_accum=int8, ctx=CPU)
    params = params_from_jax(ref["params"], cfg, device="cpu")
    state = opt.init(params)
    batch = _port_batch(ref["batch"])
    seen = []
    for t in range(steps):
        params, state, metrics = fn(params, state, t, batch)
        seen.append({k: float(v) for k, v in metrics.items()})
    return seen, params, state


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_train(got, want, state_rel: float = 1e-4):
    (m_got, p_got, s_got), (m_want, p_want, s_want) = got, want
    for a, b in zip(m_got, m_want):
        assert set(a) == set(b)
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    for (path, x), (_, y) in zip(_flatten_with_paths(p_got), _flatten_with_paths(p_want)):
        assert _rel(x.numpy(), y) <= 1e-5, path
    s_want = jax.tree.leaves(s_want)
    s_got = [x.numpy() for x in tree_leaves(s_got)]
    assert len(s_got) == len(s_want)
    for x, y in zip(s_got, s_want):
        assert x.shape == y.shape and _rel(x, y) <= state_rel


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v3-671b"])
def test_train_step_matches_reference(arch):
    """Two steps of ``make_train_step``: granite with AdamW, deepseek-v3 (MoE,
    MLA, MTP) with Adafactor.  The optimizer state follows the gradients:
    to 1e-4, as they are held."""
    assert get_arch(arch).optimizer == {"granite-3-2b": "adamw",
                                        "deepseek-v3-671b": "adafactor"}[arch]
    _check_train(_port_train(arch, 2), _ref_train(arch, 2))


def test_accumulation_matches_reference():
    """Two microbatches summed in f32."""
    _check_train(_port_train("granite-3-2b", 2, accum=2),
                 _ref_train("granite-3-2b", 2, accum=2))


def test_int8_accumulation_matches_reference():
    """Two microbatches summed as int8 with error feedback.  The two
    packages' gradients differ by ~1e-5, which moves an element sitting on an
    int8 rounding boundary by one quantum (max |x| / 127): so after one step
    AdamW's first moment, (1 - b1) g, is held element by element to one
    quantum of its leaf, the rest as in the f32 case."""
    (m_got, p_got, s_got) = _port_train("granite-3-2b", 1, accum=2, int8=True)
    (m_want, p_want, s_want) = _ref_train("granite-3-2b", 1, accum=2, int8=True)
    _check_train((m_got, p_got, {}), (m_want, p_want, {}))
    for (path, x), (_, y) in zip(_flatten_with_paths(s_got["m"]),
                                 _flatten_with_paths(s_want["m"])):
        quantum = np.abs(y).max() / 127
        assert np.abs(x.numpy() - y).max() <= 1.01 * quantum, path


def test_train_loss_decreases_internlm2():
    cfg = get_arch("internlm2-1.8b").reduced()
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    data = SyntheticLM(cfg, ShapeConfig("smoke", SEQ, BATCH, "train"), seed=1)
    opt = make_optimizer("adamw", cosine_schedule(3e-3, warmup_steps=2, total_steps=30))
    step_fn = make_train_step(cfg, opt, ctx=CPU)
    state = opt.init(params)
    batch = _port_batch(data.batch(0))  # overfit one batch
    losses = []
    for t in range(12):
        params, state, metrics = step_fn(params, state, t, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.2, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_one_bf16_train_step_updates_params_finite(arch):
    """The counterpart of the reference's smoke step: bf16 params, one step."""
    cfg = get_arch(arch).reduced()
    params = init_params(model_spec(cfg), seed=0, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    batch = _port_batch(SyntheticLM(cfg, ShapeConfig("smoke", SEQ, BATCH, "train")).batch(0))
    opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-3, warmup_steps=1))
    new, _, metrics = make_train_step(cfg, opt, ctx=CPU)(params, opt.init(params), 0, batch)
    assert np.isfinite(float(metrics["loss"])) and 0.0 < float(metrics["loss"]) < 20.0
    after = tree_leaves(new)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    assert all(bool(torch.isfinite(x.float()).all()) for x in after)
    assert all(x.dtype == torch.bfloat16 for x in after)


def test_remat_recomputes_the_same_gradients():
    """Checkpointing each repeat changes what is stored, not what is computed."""
    cfg = get_arch("jamba-v0.1-52b").reduced()
    assert cfg.remat
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    batch = _port_batch(SyntheticLM(cfg, ShapeConfig("t", SEQ, BATCH, "train")).batch(0))
    with_remat = _port_grads(params, cfg, batch)
    without = _port_grads(params, dataclasses.replace(cfg, remat=False), batch)
    assert with_remat[0] == without[0]
    for path, g in with_remat[2].items():
        np.testing.assert_array_equal(g, without[2][path], err_msg=path)


def test_train_pass_writes_no_cache():
    cfg = get_arch("granite-3-2b").reduced()
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    cache = init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="no cache"):
        forward(params, cfg, torch.zeros((1, 8), dtype=torch.long), mode="train", cache=cache)


ATTN_CASES = {
    "causal": dict(sq=24, skv=24, causal=True, q_offset=0, kv_len=24),
    "causal-offset": dict(sq=8, skv=20, causal=True, q_offset=12, kv_len=20),
    "non-causal-cross": dict(sq=12, skv=30, causal=False, q_offset=0, kv_len=30),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
@pytest.mark.parametrize("needs", ["qkv", "q"])
def test_flash_attention_fn_grads_equal_plain_autograd(case, needs):
    """``FlashAttentionFn``'s forward is K7's plain version bit for bit; its
    gradients are ``blockwise_attention``'s bit for bit (its backward, at the
    same blocks) and, in float64, the plain version's autodiff within
    1e-10."""
    c = ATTN_CASES[case]
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, c["sq"], 16), generator=gen)
    k, v = (torch.randn((2, 2, c["skv"], 16), generator=gen) for _ in range(2))
    w = torch.randn((2, 4, c["sq"], 16), generator=gen)
    kw = dict(causal=c["causal"], q_offset=c["q_offset"], kv_len=c["kv_len"])

    for dtype in (torch.float32, torch.float64):
        def grads(fn):
            ins = [t.to(dtype).requires_grad_(name in needs)
                   for name, t in zip("qkv", (q, k, v))]
            out = fn(*ins)
            wrt = [t for t in ins if t.requires_grad]
            return out.detach(), torch.autograd.grad((out * w.to(dtype)).sum(), wrt)

        got = grads(lambda *t: FlashAttentionFn.apply(*t, kw["causal"], None, kw["q_offset"],
                                                      kw["kv_len"], 8, 8))
        blockwise = grads(lambda *t: blockwise_attention(*t, q_chunk=8, kv_chunk=8, **kw))
        want = grads(lambda *t: flash_attention_plain(*t, **kw))
        assert torch.equal(got[0], want[0])
        assert len(got[1]) == len(needs)
        for a, b, p in zip(got[1], blockwise[1], want[1]):
            assert torch.equal(a, b)
            if dtype == torch.float64:
                torch.testing.assert_close(a, p, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("with_state", [False, True], ids=["y-only", "y-and-state"])
@pytest.mark.parametrize("init", [False, True], ids=["zero-start", "entering-state"])
def test_ssd_scan_fn_grads_equal_plain_autograd(with_state, init):
    gen = torch.Generator().manual_seed(1)
    b, s, h, g, p, n = 2, 40, 4, 2, 8, 16
    x = torch.randn((b, s, h, p), generator=gen)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen))
    bm, cm = (torch.randn((b, s, g, n), generator=gen) for _ in range(2))
    st0 = torch.randn((b, h, p, n), generator=gen) if init else None
    wy = torch.randn((b, s, h, p), generator=gen)
    ws = torch.randn((b, h, p, n), generator=gen)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
        st = None if st0 is None else st0.clone().requires_grad_()
        y, state = fn(*ins, st)
        loss = (y * wy).sum() + ((state * ws).sum() if with_state else 0)
        wrt = ins + ([st] if st is not None else [])
        return (y.detach(), state.detach()), torch.autograd.grad(loss, wrt)

    got = grads(lambda *t: SSDScanFn.apply(*t[:5], 16, t[5]))
    want = grads(lambda *t: ssd_scan_plain(*t[:5], chunk=16, init_state=t[5]))
    for a_, b_ in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a_, b_)


def test_train_main_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` end to end on the host, with a checkpoint."""
    out = train.main(["--arch", "mamba2-130m", "--device", "cpu", "--steps", "3", "--batch",
                      "4", "--seq", "24", "--accum", "2", "--int8-accum", "--ckpt-every", "2",
                      "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "arch=mamba2-130m-smoke params=" in text and "done: steps=3 loss" in text
    assert [s for s, _ in out["history"]] == [0, 1, 2]
    assert all(np.isfinite(l) for _, l in out["history"])
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001.json", "step_00000001.npz", "step_00000002.json", "step_00000002.npz"]
