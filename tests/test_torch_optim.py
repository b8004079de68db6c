"""The port's optimizers, schedule, clipping and int8 compression
(``repro_torch.optim``) against the reference's ``repro.optim``.

Counterparts of every case in ``tests/test_optim.py``, then parity on the
same inputs: AdamW's and Adafactor's updates and states over several steps
to 1e-6 relative norm (both compute in f32 in the same order; the
reference's XLA may fuse or reorder a reduction), the cosine schedule to
1e-6 relative (its cosine's last bit, amplified where 1 + cos is small), clipping to 1e-6, and the int8 codes of ``compress_int8``
bit for bit (``torch.round`` and ``jnp.round`` both round half to even).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim

from repro_torch.optim import (
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    global_norm,
    make_optimizer,
    tree_leaves,
    tree_map,
)

OPTS = {"adamw": adamw, "adafactor": adafactor}
SHAPES = {"w": (3, 8, 6), "b": (6,), "m": (5, 7)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_minimizes_quadratic(name):
    opt = OPTS[name](lambda step: 0.1, weight_decay=0.0)
    rng = np.random.default_rng(0)
    target = {"w": torch.tensor(rng.standard_normal((8, 8)), dtype=torch.float32),
              "b": torch.ones(8)}
    params = tree_map(torch.zeros_like, target)
    state = opt.init(params)
    losses = []
    for t in range(60):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = sum(torch.sum((leaves[k] - target[k]) ** 2) for k in leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        upd, state = opt.update(grads, state, params, t)
        params = apply_updates(params, upd)
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.05 * losses[0]


@pytest.mark.parametrize("name", sorted(OPTS))
def test_state_tree_mirrors_the_reference(name):
    """The state tree has the reference's structure, shapes and dtypes, so a
    state converts and a checkpoint of it carries across."""
    ref = getattr(ref_optim, name)(lambda s: 1e-3)
    port = OPTS[name](lambda s: 1e-3)
    ref_state = ref.init({"a": jnp.zeros((4, 6)), "b": jnp.zeros((5,))})
    state = port.init({"a": torch.zeros((4, 6)), "b": torch.zeros((5,))})
    assert jax.tree.structure(ref_state) == jax.tree.structure(
        jax.tree.map(lambda t: 0, state))
    for real, want in zip(tree_leaves(state), jax.tree.leaves(ref_state)):
        assert tuple(real.shape) == want.shape and real.dtype == torch.float32


def test_cosine_schedule_shape():
    lr = cosine_schedule(1e-3, warmup_steps=10, total_steps=100, min_ratio=0.1)
    assert lr(0) < lr(9)
    np.testing.assert_allclose(lr(10), 1e-3, rtol=1e-2)
    assert lr(100) == pytest.approx(1e-4, rel=1e-2)


def test_cosine_schedule_matches_reference():
    for args in ((1e-3, 10, 100, 0.1), (3e-3, 2, 30, 0.1), (1e-3, 5, 6, 0.25)):
        ref = ref_optim.cosine_schedule(*args)
        port = cosine_schedule(*args)
        for step in range(0, args[2] + 3):
            want = float(ref(jnp.int32(step)))
            assert port(step) == pytest.approx(want, rel=1e-6, abs=0), (args, step)


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 3.0), "b": torch.full((10,), 4.0)}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(90 + 160), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    # below the threshold: untouched
    same, _ = clip_by_global_norm(tree, 1e6)
    np.testing.assert_allclose(same["a"].numpy(), 3.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_matches_reference(dtype):
    rng = np.random.default_rng(3)
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    ref_clipped, ref_norm = ref_optim.clip_by_global_norm(
        {k: jnp.asarray(v, dtype) for k, v in tree.items()}, 0.5)
    clipped, norm = clip_by_global_norm(
        {k: torch.tensor(v).to(getattr(torch, dtype)) for k, v in tree.items()}, 0.5)
    assert _rel(float(norm), float(ref_norm)) <= 1e-6
    for k in tree:
        assert clipped[k].dtype == getattr(torch, dtype)
        assert _rel(clipped[k].float(), np.asarray(ref_clipped[k], np.float32)) <= 1e-6


def test_compress_int8_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(1000) * 5, dtype=torch.float32)
    q, scale, err = compress_int8(x)
    y = decompress_int8(q, scale)
    assert float(torch.max(torch.abs(x - y))) <= float(scale) / 2 + 1e-6
    np.testing.assert_allclose((x - y).numpy(), err.numpy(), atol=1e-6)


def test_error_feedback_removes_bias():
    """Accumulating with error feedback: the summed quantized stream converges
    to the true sum (bias cancels), unlike naive requantization."""
    rng = np.random.default_rng(1)
    xs = [torch.tensor(rng.standard_normal(256), dtype=torch.float32) for _ in range(50)]
    err = torch.zeros(256)
    total = torch.zeros(256)
    for x in xs:
        q, s, err = compress_int8(x, err)
        total = total + decompress_int8(q, s)
    true = sum(xs)
    resid = float(torch.max(torch.abs(total - true)))
    # the residual is bounded by the final error-feedback buffer (one quantum)
    assert resid <= float(torch.max(torch.abs(err))) + 1e-5


def test_compress_int8_matches_reference_bitwise():
    rng = np.random.default_rng(4)
    # halves on purpose: x / scale lands on .5 for some entries
    x = np.concatenate([rng.standard_normal(997).astype(np.float32) * 3,
                        np.float32([127.0, -63.5, 0.5, -0.5])])
    e = (rng.standard_normal(x.shape) * 1e-2).astype(np.float32)
    for carried in (None, e):
        q_r, s_r, e_r = ref_optim.compress_int8(
            jnp.asarray(x), None if carried is None else jnp.asarray(carried))
        q, s, err = compress_int8(torch.tensor(x),
                                  None if carried is None else torch.tensor(carried))
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
        assert q.dtype == torch.int8
        assert float(s) == float(s_r)
        np.testing.assert_allclose(err.numpy(), np.asarray(e_r), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                      np.asarray(ref_optim.decompress_int8(q_r, s_r)))


@pytest.mark.parametrize("name", sorted(OPTS))
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_update_matches_reference(name, weight_decay):
    """Same gradients in, six steps through warmup and decay: updates, states
    and parameters agree to 1e-6 relative norm."""
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    ref = getattr(ref_optim, name)(
        ref_optim.cosine_schedule(1e-2, warmup_steps=2, total_steps=6),
        weight_decay=weight_decay)
    port = make_optimizer(name, cosine_schedule(1e-2, warmup_steps=2, total_steps=6),
                          weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = ref.init(jp), port.init(tp)
    for step in range(6):
        g = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
             for k, s in SHAPES.items()}
        ju, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                            jnp.int32(step))
        tu, ts = port.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp, step)
        jp = ref_optim.apply_updates(jp, ju)
        tp = apply_updates(tp, tu)
        for k in SHAPES:
            assert _rel(tu[k], ju[k]) <= 1e-6, (step, k)
            assert _rel(tp[k], jp[k]) <= 1e-6, (step, k)
        for got, want in zip(tree_leaves(ts), jax.tree.leaves(js)):
            assert _rel(got, want) <= 1e-6, step


@pytest.mark.parametrize("name", sorted(OPTS))
def test_bf16_leaf_rounds_as_the_reference(name):
    """A bf16 parameter takes the f32 update cast to bf16, then the add."""
    rng = np.random.default_rng(6)
    p = rng.standard_normal((16, 8)).astype(np.float32)
    g = rng.standard_normal((16, 8)).astype(np.float32)
    ref = getattr(ref_optim, name)(lambda s: 1e-2)
    port = OPTS[name](lambda s: 1e-2)
    jp = {"p": jnp.asarray(p, jnp.bfloat16)}
    tp = {"p": torch.tensor(p).to(torch.bfloat16)}
    ju, _ = ref.update({"p": jnp.asarray(g, jnp.bfloat16)}, ref.init(jp), jp, jnp.int32(0))
    tu, _ = port.update({"p": torch.tensor(g).to(torch.bfloat16)}, port.init(tp), tp, 0)
    want = np.asarray(ref_optim.apply_updates(jp, ju)["p"], np.float32)
    got = apply_updates(tp, tu)["p"]
    assert got.dtype == torch.bfloat16
    # the f32 updates agree to 1e-6; their bf16 casts then round alike but
    # where an update sits on a bf16 rounding boundary
    assert float((got.float().numpy() != want).mean()) <= 0.01


def test_apply_updates_in_place():
    p = {"a": torch.ones(3, dtype=torch.bfloat16)}
    alias = p["a"]
    out = apply_updates(p, {"a": torch.full((3,), 0.5)})
    assert out["a"] is alias and torch.equal(alias, torch.full((3,), 1.5, dtype=torch.bfloat16))


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        make_optimizer("sgd", lambda s: 0.1)
