"""The train loss's head and CE on each rank's own tokens (``models.model._head_ce``).

On a fake world of 8 ranks (``launch.lowering.fake_world``) backing a (2, 4)
``("data", "model")`` mesh, ``lower_step`` traces reduced granite-3-2b train
steps (the CE's f32 path included, on ``cpu`` tensors: autograd on fake
``cuda`` tensors needs the CUDA build of PyTorch) while a subclass of its
``StepCounter`` records the shape of every local op output a rank makes
(DTensor's global-shape propagation runs left out):

* **The vocabulary does not divide the model axis, the sequence does**
  (``vocab=258`` on 4 ranks, as granite's 49,155 on 16): no op output with
  the vocabulary as its last dim holds more than the rank's own B/2 x S/4
  tokens (the weight's (d, V) gradient aside): neither the global batch's
  rows, which DTensor's backward of the head's matmul made on PyTorch 2.11,
  nor the rank's whole sequence, which the head's gathered input made here;
  the head sees each rank's (B/2, S/4) tokens against the whole vocabulary.
* **The vocabulary divides, the sequence does not** (a train length of 30):
  each rank's logits are (B/2, S, V/4), and no op output has the whole
  vocabulary as its last dim (the embedding's lookup gathers its (V, d)
  table, a parameter, not logits).

On one device ``compute_loss``'s loss and every gradient are bit-equal to
the unfused expression it replaced (the head's matmul, then the CE, kept
here), and within ``tests/test_torch_train.py``'s tolerances of the
reference's ``compute_loss`` and ``jax.grad`` (loss 1e-5 relative, each leaf
1e-4 relative norm), for granite-3-2b (tied), mamba2-130m (tied) and
deepseek-v3-671b (untied, with the MTP head).  The sharded values are held
against one device on the gloo world (``tests/test_torch_distributed.py``).
"""

import math
import os
import sys
from dataclasses import replace

import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX

from repro.checkpoint.ckpt import _flatten_with_paths  # noqa: E402
from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.data.synthetic import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models.model import compute_loss as ref_compute_loss  # noqa: E402
from repro.models.model import model_spec as ref_model_spec  # noqa: E402
from repro.models.sharding import BASE_RULES  # noqa: E402
from repro.models.spec import init_params as ref_init_params  # noqa: E402

from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch, rules_for  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.engine import ExecutionContext  # noqa: E402
from repro_torch.launch import lowering  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.layers import rmsnorm  # noqa: E402
from repro_torch.optim import tree_leaves, tree_map  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train import BATCH as REF_BATCH  # noqa: E402
from test_torch_train import GRAD_REL, SEQ, _np_tree, _port_batch, _worst_leaf  # noqa: E402

BATCH = 8
CPU = ExecutionContext(device="cpu")


def _reference(arch: str) -> dict:
    """The reference's f32 params, batch, loss and gradients at
    ``tests/test_torch_train.py``'s shape, its ``value_and_grad`` jitted (a
    third quicker than eager here)."""
    rcfg = ref_get_arch(arch).reduced()
    params = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jax.numpy.float32)
    batch = RefSyntheticLM(rcfg, RefShapeConfig("t", SEQ, REF_BATCH, "train"), seed=0).batch(0)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_compute_loss(p, rcfg, BASE_RULES, jb), has_aux=True))(params)
    return {"params": _np_tree(params), "batch": batch, "loss": float(loss),
            "grads": dict(_flatten_with_paths(_np_tree(grads)))}


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    lowering.fake_world(8)
    yield init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    if dist.is_initialized():
        dist.destroy_process_group()


def _trace(monkeypatch, mesh, cfg, seq: int):
    """Trace one sharded train step of ``cfg`` at ``BATCH`` x ``seq``: (every
    local op output's shape, each call of the per-rank head as (its logits'
    shape, its labels' shape))."""
    shapes, heads = [], []

    class Recorder(lowering.StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and not lowering._in_propagation():
                shapes.extend(tuple(t.shape) for t in lowering._tensors(out))
            return out

    real = model._head_token_ce

    def spy(x, w, labels, vdim, split=None):
        heads.append(((*x.shape[:-1], w.shape[vdim]), tuple(labels.shape)))
        return real(x, w, labels, vdim, split=split)

    monkeypatch.setattr(lowering, "StepCounter", Recorder)
    monkeypatch.setattr(model, "_head_token_ce", spy)
    shape = ShapeConfig("t", seq, BATCH, "train")
    lowering.lower_step(cfg, shape, mesh, rules_for(cfg, shape, mesh_model=4, mesh_data=2),
                        device="cpu")
    monkeypatch.undo()
    return shapes, heads


def test_a_vocabulary_the_model_axis_does_not_split_leaves_the_batch_split(mesh, monkeypatch):
    cfg = replace(get_arch("granite-3-2b").reduced(), vocab=258)
    seq = 64
    shapes, heads = _trace(monkeypatch, mesh, cfg, seq)
    assert heads == [((BATCH // 2, seq // 4, cfg.vocab), (BATCH // 2, seq // 4))]
    # logits-shaped outputs (the weight's (d, V) gradient aside) of more
    # tokens than the rank's own: the global batch's rows (DTensor's head
    # backward on PyTorch 2.11) or the rank's whole sequence (a gathered x)
    tokens = (BATCH // 2) * (seq // 4)
    wide = [s for s in shapes if len(s) >= 2 and s[-1] == cfg.vocab
            and s != (cfg.d_model, cfg.vocab) and math.prod(s[:-1]) > tokens]
    assert not wide, wide


def test_a_sequence_the_model_axis_does_not_split_takes_the_vocab_parallel_ce(
        mesh, monkeypatch):
    cfg = get_arch("granite-3-2b").reduced()
    seq = 30
    assert seq % 4 and cfg.vocab % 4 == 0
    shapes, heads = _trace(monkeypatch, mesh, cfg, seq)
    assert heads == [((BATCH // 2, seq, cfg.vocab // 4), (BATCH // 2, seq))]
    whole = [s for s in shapes if len(s) >= 2 and s[-1] == cfg.vocab]
    assert not whole, whole


def _unfused_loss(params, cfg, batch):
    """``compute_loss`` as it was before the head and the CE became one
    per-rank function: the logits, then the masked mean CE."""
    def ce(h, labels):
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["embed"]["unembed"]
        logits = (h @ w).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
        mask = (labels >= 0).to(torch.float32)
        return ((lse - tgt) * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    x, aux, _ = model.forward(params, cfg, batch["tokens"], mode="train", ctx=CPU)
    loss = ce(x, batch["labels"]) + aux
    if cfg.mtp:
        mtp = params["mtp"]
        emb_next = model._embed(params, batch["tokens"][:, 1:])
        h = torch.cat([rmsnorm(x[:, :-1], mtp["norm_h"], cfg.norm_eps),
                       rmsnorm(emb_next, mtp["norm_e"], cfg.norm_eps)], dim=-1)
        loss = loss + cfg.mtp_weight * ce(h @ mtp["proj"], batch["labels"][:, 1:])
    return loss


def _loss_and_grads(fn, params):
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = fn(leaves)
    flat = tree_leaves(leaves)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m", "deepseek-v3-671b"])
def test_one_device_is_the_unfused_expression_bit_for_bit(arch):
    ref = _reference(arch)
    cfg = get_arch(arch).reduced()
    params = params_from_jax(ref["params"], cfg, device="cpu")
    batch = _port_batch(ref["batch"])
    loss, grads = _loss_and_grads(lambda p: model.compute_loss(p, cfg, batch, ctx=CPU)[0],
                                  params)
    want, want_grads = _loss_and_grads(lambda p: _unfused_loss(p, cfg, batch), params)
    assert torch.equal(loss, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert float(loss) == pytest.approx(ref["loss"], rel=1e-5)
    named = {p: g.numpy() for (p, _), g in zip(_flatten_with_paths(params), grads)}
    assert set(named) == set(ref["grads"])
    worst, where = _worst_leaf(named, ref["grads"])
    assert worst <= GRAD_REL, (where, worst)
