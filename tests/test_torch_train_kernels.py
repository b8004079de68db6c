"""Training through kernels K7 and K8 on the card.

K7 and K8 are forward kernels bound with ``ctypes``: their outputs carry no
``grad_fn``.  Training takes them through ``FlashAttentionFn``, whose
backward is the blockwise attention's, and ``SSDScanFn``, whose backward
differentiates the plain scan; the
wrappers ``flash_attention`` and ``ssd_scan`` take that route themselves for
grad-requiring CUDA inputs (``ssd_scan_scalar``, which has no autograd
function, refuses them), so that no caller gets a detached result.  Every test here needs an NVIDIA card (marked ``gpu``) and
skips without one; nothing here imports JAX.

Tolerances: an autograd function's forward equals its raw kernel call bit
for bit; its gradients match plain autograd to one bf16 ulp (2^-7) of each
gradient's largest entry in bf16 and to 1e-5 relative norm in f32 (K8's
backward is the plain version's own, fed the same cotangent; K7's the
blockwise one, the same softmax algebra a block pair at a time).  Two reduced
train steps through the kernels match the same steps on the plain versions
to 1e-3 relative (loss, grad norm, parameters), the serving paths'
tolerance for reduced f32 logits, or to twice what one-ulp nudges of the
weights do to the plain run where the kernel run differs by more.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.engine import ExecutionContext
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ssd_scan as k8
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import model_spec
from repro_torch.models.spec import init_params
from repro_torch.optim import cosine_schedule, make_optimizer, tree_leaves

REL = 1e-3
FAMILIES = ("granite-3-2b", "kimi-k2-1t-a32b", "deepseek-v3-671b", "mamba2-130m",
            "jamba-v0.1-52b", "whisper-medium", "llama-3.2-vision-90b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


def _close(got, want, dtype) -> bool:
    if dtype == torch.bfloat16:
        return float((got.float() - want.float()).abs().max()) <= 2.0 ** -7 * float(
            want.float().abs().max())
    return _rel(got, want) <= 1e-5


def _attn_inputs(dev, dtype, sq, skv, h=8, g=2, hd=64, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((2, h, sq, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((2, g, skv, hd), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    w = torch.randn((2, h, sq, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, w


def _ssd_inputs(dev, dtype, b=2, s=200, h=8, g=1, p=64, n=128, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=dev).to(dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(b, s, g, n)
    dt = 0.01 + 0.19 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=dev))
    w = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    return x, dt, a, bm, cm, w


@pytest.mark.gpu
def test_wrappers_take_the_autograd_route_where_a_gradient_is_wanted(cuda):
    """``flash_attention`` and ``ssd_scan`` on grad-requiring inputs launch the
    kernel forward and give plain autograd's gradient; ``ssd_scan_scalar``
    still refuses; under no_grad the raw launch serves."""
    q, k, v, w = _attn_inputs(cuda, torch.bfloat16, 64, 64)

    def grads(fn, ins, weight):
        ins = [t.clone().requires_grad_() for t in ins]
        out = fn(*ins)
        first = out[0] if isinstance(out, tuple) else out
        return out, torch.autograd.grad((first.float() * weight.float()).sum(), ins)

    before = k7.flash_attention.launches
    out, got = grads(k7.flash_attention, (q, k, v), w)
    assert k7.flash_attention.launches == before + 1 and out.grad_fn is not None
    _, want = grads(k7.flash_attention_plain, (q, k, v), w)
    for g, gw in zip(got, want):
        assert _close(g, gw, torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(k7.flash_attention(q, k, v), out.detach())

    x, dt, a, bm, cm, wy = _ssd_inputs(cuda, torch.bfloat16)
    before = k8.ssd_scan.launches
    (y, _), got = grads(lambda *t: k8.ssd_scan(*t, chunk=128), (x, dt, a, bm, cm), wy)
    assert k8.ssd_scan.launches == before + 1 and y.grad_fn is not None
    _, want = grads(lambda *t: k8.ssd_scan_plain(*t, chunk=128), (x, dt, a, bm, cm), wy)
    for g, gw in zip(got, want):
        assert _close(g, gw, g.dtype)
    with pytest.raises(RuntimeError, match="SSDScanFn"):
        k8.ssd_scan_scalar(x, dt, a.clone().requires_grad_(), bm, cm)
    with torch.no_grad():
        k8.ssd_scan_scalar(x, dt, a, bm, cm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(128, 128, True, 0), (40, 90, True, 50), (128, 300, False, 0)],
                         ids=["causal", "causal-offset", "non-causal-cross"])
def test_flash_attention_fn_matches_plain_autograd(cuda, dtype, shape):
    sq, skv, causal, off = shape
    q, k, v, w = _attn_inputs(cuda, dtype, sq, skv)
    kw = dict(causal=causal, q_offset=off, kv_len=skv)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return out.detach(), torch.autograd.grad((out.float() * w.float()).sum(), ins)

    before = k7.flash_attention.launches
    out, grads = run(lambda *t: k7.FlashAttentionFn.apply(*t, causal, None, off, skv))
    assert k7.flash_attention.launches == before + 1
    with torch.no_grad():
        assert torch.equal(out, k7.flash_attention(q, k, v, **kw))
    _, want = run(lambda *t: k7.flash_attention_plain(*t, **kw))
    for g, gw in zip(grads, want):
        assert g.dtype == dtype and _close(g, gw, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_ssd_scan_fn_matches_plain_autograd(cuda, dtype):
    x, dt, a, bm, cm, w = _ssd_inputs(cuda, dtype)

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (x, dt, a, bm, cm)]
        y, state = fn(*ins)
        return (y.detach(), state.detach()), torch.autograd.grad(
            (y.float() * w.float()).sum(), ins)

    before = k8.ssd_scan.launches
    (y, st), grads = run(lambda *t: k8.SSDScanFn.apply(*t, 128, None))
    assert k8.ssd_scan.launches == before + 1
    with torch.no_grad():
        y_raw, st_raw = k8.ssd_scan(x, dt, a, bm, cm)
    assert torch.equal(y, y_raw) and torch.equal(st, st_raw)
    _, want = run(lambda *t: k8.ssd_scan_plain(*t, chunk=128))
    for g, gw in zip(grads, want):
        assert _close(g, gw, g.dtype)


def _nudged(params: dict, seed: int, prefix: str) -> dict:
    """``params`` with every leaf whose name starts with ``prefix`` moved one
    ulp up or down at random."""
    gen = torch.Generator(device=params["norm_f"].device).manual_seed(seed)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not name.startswith(prefix):
            return tree
        sign = torch.randint(0, 2, tree.shape, generator=gen, device=tree.device) * 2 - 1
        return torch.nextafter(tree, tree + sign.to(tree.dtype))

    return walk(params)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_train_step_kernels_match_plain(cuda, arch):
    """Two f32 steps on the kernels against two on the plain versions: the
    first step's loss and grad norm, the second step's loss and the
    parameters after both, each to 1e-3 relative, or, where the kernel run
    differs by more, to twice the most that six one-ulp nudges of the
    weights do to the plain run.  (From random weights the reduced VLM
    trains chaotically: its second step's grad norm spreads over several
    times itself across such nudges, so it is not held.)"""
    cfg = get_arch(arch).reduced()
    batch = SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"), seed=0).batch(0)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    batch["tokens"] = batch["tokens"].long()
    base = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device=cuda)

    def two_steps(impl, params):
        ctx = ExecutionContext(device="cuda", kernel_impl=None if impl == "kernel" else "plain")
        opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-3, warmup_steps=1))
        step, state = make_train_step(cfg, opt, ctx=ctx), opt.init(params)
        launches = (k7.flash_attention.launches, k8.ssd_scan.launches)
        seen = []
        for t in range(2):
            params, state, metrics = step(params, state, t, batch)
            seen.append(metrics)
        return (seen, torch.cat([p.flatten() for p in tree_leaves(params)]),
                (k7.flash_attention.launches - launches[0], k8.ssd_scan.launches - launches[1]))

    m_k, p_k, n_k = two_steps("kernel", _clone(base))
    m_p, p_p, n_p = two_steps("plain", _clone(base))
    assert n_p == (0, 0)
    assert (n_k[0] > 0) == any(mx in ("attn", "attn_nc", "attn_x", "xattn")
                               for st in cfg.stages for mx, _ in st.layers)
    assert (n_k[1] > 0) == (cfg.ssm is not None)

    def diffs(m, p):
        return [_rel(m[0]["loss"], m_p[0]["loss"]), _rel(m[0]["grad_norm"], m_p[0]["grad_norm"]),
                _rel(m[1]["loss"], m_p[1]["loss"]), _rel(p, p_p)]

    errs, limits = diffs(m_k, p_k), [REL] * 4
    if max(errs) > REL:
        spread = [max(v) for v in zip(*(
            diffs(*two_steps("plain", _nudged(_clone(base), seed,
                                              "norm" if seed < 3 else ""))[:2])
            for seed in range(6)))]
        limits = [max(REL, 2 * v) for v in spread]
    for name, err, lim in zip(("loss", "grad norm", "second loss", "params"), errs, limits):
        assert err <= lim, (name, err, lim)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()
