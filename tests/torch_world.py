"""Gloo worlds on the CPU for the port's multi-process paths.

``python tests/torch_world.py JOB WORLD OUT_DIR`` spawns WORLD processes that
join one ``torch.distributed`` gloo group on a free localhost port and run
JOB; rank 0 writes what the tests compare to ``OUT_DIR/JOB.npz``.  Jobs:

* ``wide`` (8 ranks): ``compressed_psum`` of rank r's row of
  ``OUT_DIR/psum_in.npz``; the expert-parallel MoE (``jamba-v0.1-52b``
  reduced) on the weights and input of ``OUT_DIR/moe_in.npz`` on a (2, 4)
  mesh (the weight-stationary body); the loss gradients of
  ``kimi-k2-1t-a32b`` reduced there; and one sharded train step of
  ``granite-3-2b`` and ``mamba2-130m`` reduced on a (2, 4) mesh, with its
  loss, ``grad_norm`` and updated parameters.
* ``serve`` (8 ranks): the sharded prefill and decode steps
  (``make_prefill_step`` / ``make_decode_step`` with ``mesh=`` and
  ``rules=``) of each of ``SERVE_ARCHS`` reduced on a (2, 4) mesh, in f32
  from the seed-0 weights (``init_params(..., mesh=)``), each rule table
  ``rules_for``'s for its kind: the prefill's logits, the cache placed by the
  decode rules (its sequence dim over ``model``), and two decode steps'
  logits and cache placements.
* ``narrow`` (4 ranks): the MoE on a (1, 4) mesh (``_ep_body``) and kimi's
  gradients there; ``train_loop`` on a (2, 2) mesh resuming from the
  one-process checkpoint in ``OUT_DIR/ckpt`` and taking steps 1 and 2, with
  a fault injected on every rank before step 2 the first time (the loop
  restores step 1 and replays); and ``init_params(..., mesh=)``'s blocks
  against ``distribute_params`` of the whole draw.

Imported by ``tests/test_torch_distributed.py`` (not a test module itself).
"""

from __future__ import annotations

import json
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

SHAPE = ("t", 32, 8, "train")     # the train jobs' ShapeConfig
TRAIN_ARCHS = ("granite-3-2b", "mamba2-130m")
MOE_ARCH = "kimi-k2-1t-a32b"
ELASTIC_STEPS = 3                 # the elastic run ends after step 2
FAULT_STEP = 2                    # every rank raises before this step, once
SERVE_ARCHS = ("granite-3-2b", "mamba2-130m", "kimi-k2-1t-a32b", "deepseek-v3-671b",
               "whisper-medium", "llama-3.2-vision-90b", "jamba-v0.1-52b")
SERVE_PROMPT, SERVE_CAP, SERVE_BATCH = 16, 24, 8   # prompt, cache capacity, batch
SERVE_DECODES = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _full(tree):
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy()}


def _psum(out_dir, rank, world) -> dict:
    from repro_torch.optim.compress import compressed_psum

    x = torch.from_numpy(np.load(os.path.join(out_dir, "psum_in.npz"))["x"][rank])
    total, err = compressed_psum(x)
    got = [torch.zeros_like(total) for _ in range(world)]
    errs = [torch.zeros_like(err) for _ in range(world)]
    dist.all_gather(got, total)
    dist.all_gather(errs, err)
    return {"psum:total": torch.stack(got).numpy(), "psum:err": torch.stack(errs).numpy()}


def _moe(out_dir, mesh_shape) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.moe import EP_STATS, _moe_ep, moe_apply
    from repro_torch.models.sharding import BASE_RULES, constrain, set_mesh

    z = np.load(os.path.join(out_dir, "moe_in.npz"))
    p = {k: torch.from_numpy(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(z["x"])
    cfg = get_arch("jamba-v0.1-52b").reduced()
    EP_STATS["calls"] = 0
    with set_mesh(_mesh(mesh_shape)) as mesh:
        out, aux = moe_apply(p, x, cfg)
        calls = EP_STATS["calls"]
        # the EP body's own output, before moe_apply constrains it
        body, _ = _moe_ep(p, x, cfg, mesh, weight_stationary=mesh_shape[0] > 1)
        # the reference constrains the layer's output to its activation axes
        constrained = constrain(out, BASE_RULES, "batch", "seq", "embed")
    return {"moe:out": out.full_tensor().numpy(), "moe:aux": aux.numpy(),
            "moe:placements": np.array([str(pl) for pl in out.placements]),
            "moe:body_placements": np.array([str(pl) for pl in body.placements]),
            "moe:constrained": np.array([str(pl) for pl in constrained.placements]),
            "moe:constrained_out": constrained.full_tensor().numpy(),
            "moe:allreduces": np.array(calls)}


def _train_setup(arch, mesh_shape):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, rules_for
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.launch.steps import make_train_step, train_state_placements
    from repro_torch.optim import cosine_schedule, make_optimizer

    cfg = get_arch(arch).reduced()
    shape = ShapeConfig(*SHAPE)
    mesh = _mesh(mesh_shape)
    rules = rules_for(cfg, shape, mesh_model=mesh_shape[1], mesh_data=mesh_shape[0])
    opt = make_optimizer("adamw", cosine_schedule(1e-3))
    step = make_train_step(cfg, opt, ctx=ExecutionContext(device="cpu"), mesh=mesh,
                           rules=rules)
    return cfg, shape, mesh, rules, opt, step, train_state_placements(cfg, rules, mesh, opt)


def _sharded_grads(cfg, params, batch, rules, mesh):
    """The loss gradient of every leaf on the mesh, redistributed to its
    leaf's placements (the forward and backward the sharded step runs)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.engine import ExecutionContext
    from repro_torch.launch.steps import shard_batch
    from repro_torch.models.model import compute_loss
    from repro_torch.models.sharding import set_mesh
    from repro_torch.optim import tree_map

    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with set_mesh(mesh), implicit_replication():
        loss, _ = compute_loss(leaves, cfg, shard_batch(batch, rules, mesh),
                               ctx=ExecutionContext(device="cpu"))
        loss.backward()
    return tree_map(lambda p: p.grad.redistribute(p.device_mesh, p.placements), leaves)


def _batch(data, step: int) -> dict:
    return {k: torch.as_tensor(v) for k, v in data.batch(step).items()}


def _moe_grads(mesh_shape) -> dict:
    """The reduced MoE arch's loss gradients on a ``mesh_shape`` mesh."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import distribute_params, init_params

    cfg, shape, mesh, rules, *_ = _train_setup(MOE_ARCH, mesh_shape)
    spec = model_spec(cfg)
    params = distribute_params(init_params(spec, seed=0, dtype=torch.float32, device="cpu"),
                               spec, rules, mesh)
    grads = _full(_sharded_grads(cfg, params, _batch(SyntheticLM(cfg, shape), 0), rules, mesh))
    return {f"{MOE_ARCH}:grad:{k}": v for k, v in _flat(grads).items()}


def _train(mesh_shape) -> dict:
    """One sharded step of each train arch from its seed-0 f32 weights."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import distribute_params, init_params

    out = {}
    for arch in TRAIN_ARCHS:
        cfg, shape, mesh, rules, opt, step, _ = _train_setup(arch, mesh_shape)
        spec = model_spec(cfg)
        params = init_params(spec, seed=0, dtype=torch.float32, device="cpu")
        state = opt.init(params)
        params = distribute_params(params, spec, rules, mesh)
        state = distribute_params(state, opt.state_spec(spec), rules, mesh)
        batch = _batch(SyntheticLM(cfg, shape), 0)
        for k, v in _flat(_full(_sharded_grads(cfg, params, batch, rules, mesh))).items():
            out[f"{arch}:grad:{k}"] = v
        params, state, metrics = step(params, state, 0, batch)
        out[f"{arch}:loss"] = metrics["loss"].numpy()
        out[f"{arch}:grad_norm"] = metrics["grad_norm"].numpy()
        for k, v in _flat(_full(params)).items():
            out[f"{arch}:{k}"] = v
    return out


def _elastic(out_dir, rank, world, mesh_shape) -> dict:
    """``train_loop`` on the mesh from the one-process checkpoint of step 0,
    with a fault on every rank before ``FAULT_STEP`` (the first time): what
    each rank ran, its ``grad_norm`` and loss a step, and its restarts."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import init_params
    from repro_torch.train.loop import TrainLoopConfig, train_loop

    cfg, shape, mesh, rules, opt, step, (pp, op) = _train_setup(TRAIN_ARCHS[0], mesh_shape)
    spec = model_spec(cfg)
    data = SyntheticLM(cfg, shape)

    def init_state():   # a fresh start would draw another seed: the restore must win
        params = init_params(spec, seed=1, dtype=torch.float32, device="cpu")
        return params, opt.init(params)

    ran = []
    faulted = []

    def fault_hook(s):
        if s == FAULT_STEP and not faulted:
            faulted.append(s)
            raise RuntimeError("injected node fault")

    def on_metrics(s, m):
        ran.append((s, float(m["loss"]), float(m["grad_norm"])))

    res = train_loop(step, init_state, lambda s: _batch(data, s),
                     TrainLoopConfig(total_steps=ELASTIC_STEPS, ckpt_every=1, async_ckpt=True,
                                     ckpt_dir=os.path.join(out_dir, "ckpt")),
                     fault_hook=fault_hook, on_metrics=on_metrics, placements=(mesh, pp, op))
    mine = {"ran": ran, "restarts": res["restarts"], "history": res["history"],
            "placed": type(res["params"]["norm_f"]).__name__}
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    return {"elastic:ranks": np.array(json.dumps(ranks))}


def _placed_init(rank, world, mesh_shape) -> dict:
    """Whether every rank's blocks from ``init_params(..., mesh=)`` equal
    those ``distribute_params`` cuts from the whole draw (a model with
    stacked layers and the MoE's expert banks)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch, rules_for
    from repro_torch.models.model import model_spec
    from repro_torch.models.moe import moe_spec
    from repro_torch.models.spec import _leaf_paths, distribute_params, init_params

    mesh = _mesh(mesh_shape)
    bad = []
    for arch, spec_of in ((TRAIN_ARCHS[0], model_spec), ("jamba-v0.1-52b", moe_spec)):
        cfg = get_arch(arch).reduced()
        spec = spec_of(cfg)
        rules = rules_for(cfg, ShapeConfig(*SHAPE), mesh_model=mesh_shape[1],
                          mesh_data=mesh_shape[0])
        placed = init_params(spec, seed=0, dtype=torch.float32, device="cpu", mesh=mesh,
                             rules=rules)
        cut = distribute_params(init_params(spec, seed=0, dtype=torch.float32, device="cpu"),
                                spec, rules, mesh)
        for (path, a), (_, b) in zip(_leaf_paths(placed), _leaf_paths(cut)):
            if not (isinstance(a, DTensor) and a.placements == b.placements
                    and a.shape == b.shape and torch.equal(a.to_local(), b.to_local())):
                bad.append(f"{arch}:{path}")
    ranks = [None] * world
    dist.all_gather_object(ranks, bad)
    return {"placed_init:bad": np.array(json.dumps(ranks))}


def serve_inputs(cfg) -> tuple:
    """(prompt tokens (B, SERVE_PROMPT), decode tokens (B, SERVE_DECODES),
    the stub frontend or None) as numpy, from ``SyntheticLM``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import SyntheticLM

    batch = SyntheticLM(cfg, ShapeConfig("serve", SERVE_CAP, SERVE_BATCH, "train")).batch(0)
    toks = batch["tokens"]
    front = next((batch[k] for k in ("enc_embeds", "img_embeds") if k in batch), None)
    return (toks[:, :SERVE_PROMPT], toks[:, SERVE_PROMPT:SERVE_PROMPT + SERVE_DECODES],
            front)


def serve_rules(cfg, mesh_shape):
    """The prefill's and the decode's rule tables (``rules_for``)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import rules_for

    data, model = mesh_shape
    return tuple(rules_for(cfg, ShapeConfig(f"mini_{kind}", SERVE_CAP, SERVE_BATCH, kind),
                           mesh_model=model, mesh_data=data)
                 for kind in ("prefill", "decode"))


def _serve(mesh_shape) -> dict:
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.engine import ExecutionContext
    from repro_torch.launch.steps import cache_placements, make_decode_step, make_prefill_step
    from repro_torch.models.model import model_spec
    from repro_torch.models.spec import _leaf_paths, init_params

    mesh = _mesh(mesh_shape)
    cpu = ExecutionContext(device="cpu")
    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).reduced()
        pre_rules, dec_rules = serve_rules(cfg, mesh_shape)
        params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu",
                             mesh=mesh, rules=pre_rules)
        toks, dec_toks, front = serve_inputs(cfg)
        prefill = make_prefill_step(cfg, SERVE_CAP, ctx=cpu, mesh=mesh, rules=pre_rules)
        decode = make_decode_step(cfg, ctx=cpu, mesh=mesh, rules=dec_rules)
        logits, cache = prefill(params, torch.as_tensor(toks),
                                None if front is None else torch.as_tensor(front))
        out[f"{arch}:prefill"] = logits.full_tensor().numpy()
        want = dict(_leaf_paths(cache_placements(cfg, dec_rules, mesh, SERVE_BATCH,
                                                 SERVE_CAP)))

        def place(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: place(v, f"{prefix}/{k}") for k, v in tree.items()}
            return tree.redistribute(mesh, want[prefix])

        cache = place(cache)
        for j in range(SERVE_DECODES):
            logits, cache = decode(params, cache, torch.as_tensor(dec_toks[:, j:j + 1]),
                                   SERVE_PROMPT + j)
            out[f"{arch}:decode{j}"] = logits.full_tensor().numpy()
        held = [isinstance(v, DTensor) and list(v.placements) == list(want[k])
                for k, v in _leaf_paths(cache)]
        out[f"{arch}:cache_placed"] = np.array(bool(held) and all(held))
        out[f"{arch}:kv_seq_sharded"] = np.array(any(
            str(pl) != "R" for k, pls in want.items() for pl in pls))
    return out


def job_serve(out_dir, rank, world):
    return _serve((2, world // 2))


def job_wide(out_dir, rank, world):
    out = _psum(out_dir, rank, world)
    out.update(_moe(out_dir, (2, world // 2)))
    out.update(_moe_grads((2, world // 2)))
    out.update(_train((2, world // 2)))
    return out


def job_narrow(out_dir, rank, world):
    out = _moe(out_dir, (1, world))
    out.update(_moe_grads((1, world)))
    out.update(_elastic(out_dir, rank, world, (2, world // 2)))
    out.update(_placed_init(rank, world, (2, world // 2)))
    return out


JOBS = {"wide": job_wide, "narrow": job_narrow, "serve": job_serve}


def _worker(rank, job, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = JOBS[job](out_dir, rank, world)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"{job}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    job, world, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    mp.spawn(_worker, args=(job, world, free_port(), out_dir), nprocs=world)
