"""The port's multi-process paths against the reference's, in gloo worlds on the CPU.

Two gloo worlds (8 and 4 processes, ``tests/torch_world.py``) and the
reference's sharded runs (8 forced host devices, meshes of ``AxisType.Auto``
axes: JAX 0.9's ``make_mesh`` defaults to ``Explicit`` axes, under which
the reference's ``constrain`` fails) run at once, each in a subprocess of
its own with a ``timeout``, as the reference's ``tests/test_distributed.py``
runs its simulated devices.  Both sides start from the same weights: the
port's seed-0 draws, handed to the reference by path.  Nothing of the
reference is changed.

* ``compressed_psum`` on 8 ranks: bit-identical, rank by rank, to the
  reference's under ``shard_map`` on 8 devices.
* The expert-parallel MoE (``jamba-v0.1-52b`` reduced, 8 experts top-2, x
  of (4, 16, d), f32) on (1, 4) (``_ep_body``) and (2, 4) (the
  weight-stationary body): within the reference's own bounds (2e-4, aux
  1e-5) of its single-device ``moe_apply``, and as close to its EP run on
  the same mesh.
* The sharded train step on a (2, 4) world, for ``granite-3-2b``,
  ``mamba2-130m`` and ``deepseek-v3-671b`` (MLA, MoE and the MTP head)
  reduced.  Against one device: the loss within the
  reference test's 5e-3 relative; every leaf's loss gradient (above 1e-4),
  its ``grad_norm`` and the update it applied (parameters after minus
  before) within twice what a one-ulp nudge of every weight, up or down,
  does to them on one device.  The update is held element by element
  where the gradient stands clear of that nudge noise (twice its leaf's
  gradient nudge): elsewhere a first AdamW step, about lr * sign(g), may
  rightly go either way.  Against the reference's step on its (2, 4) mesh
  (granite and mamba2, ``REF_MESH_ARCHS``):
  the loss to 1e-5 and ``grad_norm`` to 1e-4 relative, as
  ``tests/test_torch_train.py`` holds one device, and the reference's
  update in the same band around the port's single-device step (its
  ``grad_norm`` sits 6.7e-6 relative from the port's, outside the port's
  own nudge band: the reference sums in another order).
* The loss gradients of the head and CE on each rank's own tokens
  (``HEAD_CASES``: reduced granite at a vocabulary of 258, which the model
  axis does not split, and at a train length of 30, which it does not split,
  so the CE runs vocab-parallel) on (2, 4), held to one device as kimi-k2's.
* Elastic restore and a fault in a world: a checkpoint of step 0 written by
  one process resumes on a (2, 2) world, which takes step 1, meets a fault
  on every rank before step 2, restores step 1 and takes step 2.  Every rank
  runs steps 1 and 2 once each; each step's update and ``grad_norm`` are
  held, as above, to the single-device step from the same state (step 2's
  from the world's own checkpoint of step 1).
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.ckpt import restore_tree  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core.engine import ExecutionContext  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.model import compute_loss, model_spec  # noqa: E402
from repro_torch.models.moe import moe_spec  # noqa: E402
from repro_torch.models.spec import _leaf_paths, init_params  # noqa: E402
from repro_torch.optim import cosine_schedule, make_optimizer, tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_world import HEAD_CASES, MOE_ARCH, SHAPE, TRAIN_ARCHS, case_config  # noqa: E402

LR = cosine_schedule(1e-3)   # the worlds' schedule
# the archs whose sharded step is also held to the reference's on its mesh.
# deepseek-v3-671b is not: the reference's own one-device update sits one
# ulp of a parameter off the port's on single elements (wkv_a), outside the
# one-ulp-nudge band the update is held in; its loss and grad_norm agree
REF_MESH_ARCHS = ("granite-3-2b", "mamba2-130m")
CPU = ExecutionContext(device="cpu")
TIMEOUT = 300                # seconds, each subprocess


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


class _Run:
    """A subprocess started now and read later: ``result()`` waits for it
    and returns the arrays it wrote to ``out_path``."""

    def __init__(self, argv, env, out_path):
        self.out_path = out_path
        self.log = open(out_path + ".log", "w+")
        self.proc = subprocess.Popen(argv, stdout=self.log, stderr=subprocess.STDOUT, env=env)
        self._result = None

    def result(self) -> dict:
        if self._result is None:
            try:
                rc = self.proc.wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            self.log.seek(0)
            assert rc == 0, self.log.read()[-4000:]
            with np.load(self.out_path) as z:
                self._result = {k: z[k] for k in z.files}
        return self._result

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


REF_CODE = """
    import os, jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.checkpoint.ckpt import _flatten_with_paths
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_arch, rules_for
    from repro.data.synthetic import SyntheticLM
    from repro.launch.steps import make_train_step
    from repro.models.model import model_spec
    from repro.models.moe import moe_apply
    from repro.models.sharding import BASE_RULES, named_sharding, set_mesh, shard_map
    from repro.models.spec import param_shardings
    from repro.optim import cosine_schedule, make_optimizer
    from repro.optim.compress import compressed_psum

    out_dir = os.environ["OUT_DIR"]
    archs, shape = os.environ["TRAIN_ARCHS"].split(","), os.environ["SHAPE"].split(",")
    auto = lambda shape, names: jax.make_mesh(shape, names,
                                              axis_types=(AxisType.Auto,) * len(shape))
    out = {}

    x = np.load(os.path.join(out_dir, "psum_in.npz"))["x"]
    mesh = auto((8,), ("d",))
    fn = shard_map(lambda v: tuple(t[None] for t in compressed_psum(v[0], "d")), mesh,
                   in_specs=P("d"), out_specs=(P("d"), P("d")))
    out["total"], out["err"] = jax.jit(fn)(jnp.asarray(x))

    cfg = get_arch("jamba-v0.1-52b").reduced()
    z = np.load(os.path.join(out_dir, "moe_in.npz"))
    p = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    xm = jnp.asarray(z["x"])
    out["moe"], out["aux"] = moe_apply(p, xm, cfg, BASE_RULES)
    for shp in ((1, 4), (2, 4)):
        tag = "%d%d" % shp
        with set_mesh(auto(shp, ("data", "model"))):
            out["ep" + tag], out["aux" + tag] = jax.jit(
                lambda p, v: moe_apply(p, v, cfg, BASE_RULES))(p, xm)

    # the sharded train step on a (2, 4) mesh, from the port's weights
    z = np.load(os.path.join(out_dir, "train_in.npz"))
    shape = ShapeConfig(shape[0], int(shape[1]), int(shape[2]), shape[3])
    for arch in archs:
        cfg = get_arch(arch).reduced()
        spec = model_spec(cfg)
        load = lambda t, pre: ({k: load(v, pre + "/" + k) for k, v in t.items()}
                               if isinstance(t, dict)
                               else jnp.asarray(z[(arch + pre).replace("/", "|")]))
        params = load(spec, "")
        batch = {k: jnp.asarray(v) for k, v in SyntheticLM(cfg, shape).batch(0).items()}
        opt = make_optimizer("adamw", cosine_schedule(1e-3))
        rules = rules_for(cfg, shape, mesh_model=4, mesh_data=2)
        mesh = auto((2, 4), ("data", "model"))
        with set_mesh(mesh):
            p_sh = param_shardings(spec, rules, mesh)
            o_sh = param_shardings(opt.state_spec(spec), rules, mesh)
            b_sh = jax.tree.map(lambda v: named_sharding(mesh, P("data"), v.shape), batch)
            new, _, m = jax.jit(make_train_step(cfg, rules, opt),
                                in_shardings=(p_sh, o_sh, None, None))(
                jax.device_put(params, p_sh), jax.device_put(opt.init(params), o_sh),
                jnp.int32(0), jax.device_put(batch, b_sh))
        out[arch + ":loss"], out[arch + ":grad_norm"] = m["loss"], m["grad_norm"]
        for path, v in _flatten_with_paths(new):
            out[arch + ":" + path] = v
    np.savez(os.path.join(out_dir, "ref.npz"), **{k: np.asarray(v) for k, v in out.items()})
"""


def _setup(arch):
    cfg, shape = case_config(arch)
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    return cfg, params, SyntheticLM(cfg, shape)


def _batch(data, step):
    return {k: torch.as_tensor(v) for k, v in data.batch(step).items()}


def _leaves(params) -> dict:
    return {p: v.detach().numpy().copy() for p, v in _leaf_paths(params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs, the one-process checkpoint of step 0, and the reference
    and both worlds started at once; each is read when a test needs it."""
    out_dir = str(tmp_path_factory.mktemp("world"))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 3, 50)).astype(np.float32)
    x[3, 1, 7] = 9.5                      # one rank's absmax sets the shared scale
    x[5, 0, :4] = x[3, 1, 7] * np.array([0.5, -0.5, 1.5, 2.5]) / 127.0   # ties at .5
    np.savez(os.path.join(out_dir, "psum_in.npz"), x=x)
    moe_cfg = get_arch("jamba-v0.1-52b").reduced()
    moe_p = init_params(moe_spec(moe_cfg), seed=0, dtype=torch.float32, device="cpu")
    np.savez(os.path.join(out_dir, "moe_in.npz"),
             x=np.random.default_rng(0).standard_normal((4, 16, moe_cfg.d_model))
             .astype(np.float32), **{k: v.numpy() for k, v in moe_p.items()})
    np.savez(os.path.join(out_dir, "train_in.npz"),
             **{f"{arch}{p}".replace("/", "|"): v for arch in REF_MESH_ARCHS
                for p, v in _leaves(_setup(arch)[1]).items()})
    # step 0 on one device, checkpointed by one process, for the narrow world
    cfg, params, data = _setup(TRAIN_ARCHS[0])
    opt = make_optimizer("adamw", LR)
    state = opt.init(params)
    params, state, _ = make_train_step(cfg, opt, ctx=CPU)(params, state, 0, _batch(data, 0))
    CheckpointManager(os.path.join(out_dir, "ckpt"), async_save=False).save(0, (params, state))

    world = os.path.join(ROOT, "tests", "torch_world.py")
    started = {
        "ref": _Run([sys.executable, "-c", textwrap.dedent(REF_CODE)],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                         JAX_PLATFORMS="cpu", OUT_DIR=out_dir, TRAIN_ARCHS=",".join(REF_MESH_ARCHS),
                         SHAPE=",".join(map(str, SHAPE))),
                    os.path.join(out_dir, "ref.npz")),
        "wide": _Run([sys.executable, world, "wide", "8", out_dir], _env(OMP_NUM_THREADS="1"),
                     os.path.join(out_dir, "wide.npz")),
        "narrow": _Run([sys.executable, world, "narrow", "4", out_dir],
                       _env(OMP_NUM_THREADS="1"), os.path.join(out_dir, "narrow.npz")),
    }
    yield out_dir, started, (params, state)
    for run in started.values():
        run.close()


def _get(runs, name) -> dict:
    return runs[1][name].result()


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


def test_compressed_psum_bit_identical_to_the_reference_on_8_ranks(runs):
    got, r = _get(runs, "wide"), _get(runs, "ref")
    np.testing.assert_array_equal(got["psum:total"], r["total"])
    np.testing.assert_array_equal(got["psum:err"], r["err"])
    x = np.load(os.path.join(runs[0], "psum_in.npz"))["x"]
    # the sum it approximates, to the shared scale's half step per rank
    scale = np.float32(np.abs(x).max()) / np.float32(127.0)
    assert np.abs(got["psum:total"][0] - x.sum(0)).max() <= 8 * scale / 2 + 1e-5
    assert (got["psum:total"] == got["psum:total"][0]).all()   # every rank holds the sum


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [4, 8])
def test_ep_moe_matches_the_reference(runs, world):
    r = _get(runs, "ref")
    got = _get(runs, "narrow" if world == 4 else "wide")
    tag = "14" if world == 4 else "24"
    out, aux = got["moe:out"], float(got["moe:aux"])
    # the reference's own bounds against its single-device run
    assert np.abs(out - r["moe"]).max() < 2e-4
    assert abs(aux - float(r["aux"])) < 1e-5
    # as close to the reference's EP run on the same mesh (measured on the
    # reference's own weights: 0 at (1, 4), 7.2e-7 at (2, 4) between its runs)
    assert np.abs(out - r[f"ep{tag}"]).max() <= max(
        2 * np.abs(r[f"ep{tag}"] - r["moe"]).max(), 1e-6)
    assert abs(aux - float(r[f"aux{tag}"])) < 1e-6
    # constrain: the batch over data, the rest replicated, the values kept;
    # moe_apply constrains its own output so (the reference's site)
    assert list(got["moe:constrained"]) == ["S(0)", "R"]
    assert list(got["moe:placements"]) == ["S(0)", "R"]
    np.testing.assert_array_equal(got["moe:constrained_out"], out)
    if world == 4:   # _ep_body: batch over the (size-1) data dim, one all-reduce
        assert list(got["moe:body_placements"]) == ["S(0)", "R"]
        assert int(got["moe:allreduces"]) == 1
    else:            # the weight-stationary body: d-sharded over data, 3 all-reduces
        assert list(got["moe:body_placements"]) == ["S(2)", "R"]
        assert int(got["moe:allreduces"]) == 3


# ---------------------------------------------------------------------------
# One device, and one-ulp nudges of every weight
# ---------------------------------------------------------------------------


def _grads(cfg, params, batch, nudge: float = 0.0) -> dict:
    """The single-device loss gradients (every weight one ulp towards
    ``nudge``, +-inf, where it is not 0)."""
    to = torch.tensor(nudge)
    leaves = tree_map(lambda p: (torch.nextafter(p, to) if nudge else p.clone())
                      .detach().requires_grad_(), params)
    loss, _ = compute_loss(leaves, cfg, batch, ctx=CPU)
    loss.backward()
    return {k: v.grad.numpy() for k, v in _leaf_paths(leaves)}


def _single_step(cfg, params, state, step, batch, nudge: float = 0.0):
    """One single-device step from ``params`` (nudged as in :func:`_grads`)
    and ``state``, neither changed: (gradients, update, metrics), the update
    being the parameters after minus before."""
    to = torch.tensor(nudge)
    p = tree_map(lambda v: torch.nextafter(v, to) if nudge else v.clone(), params)
    before = _leaves(p)
    grads = _grads(cfg, p, batch)
    after, _, m = make_train_step(cfg, make_optimizer("adamw", LR), ctx=CPU)(
        p, tree_map(torch.clone, state), step, batch)
    update = {k: v - before[k] for k, v in _leaves(after).items()}
    return grads, update, {k: float(v) for k, v in m.items()}


def _band(cfg, params, state, step, batch):
    """The single-device step from ``params`` and ``state`` and the band
    that one-ulp nudges of every weight, up or down, move it in: per leaf,
    the elements whose gradient exceeds twice its leaf's gradient nudge
    (``keep``), the update and the update's nudge over them; the metrics
    and the ``grad_norm`` nudge."""
    (g, u, m), *nudged = [_single_step(cfg, params, state, step, batch, nudge=n)
                          for n in (0.0, float("inf"), float("-inf"))]
    leaves = {}
    for path in u:
        g_noise = max(float(np.abs(n[0][path] - g[path]).max()) for n in nudged)
        keep = np.abs(g[path]) > 2 * g_noise
        u_noise = max(float(np.abs(n[1][path] - u[path])[keep].max()) if keep.any() else 0.0
                      for n in nudged)
        leaves[path] = (keep, u[path], u_noise)
    gn_noise = max(abs(n[2]["grad_norm"] - m["grad_norm"]) for n in nudged)
    return leaves, m, gn_noise


def _within_band(band, update: dict, grad_norm: float | None) -> None:
    """A step (its applied ``update`` and ``grad_norm``, where given) within
    twice the band's nudges of the single-device step, the update element by
    element where the gradient stands clear of the nudge noise; most of
    every model's elements must stand so."""
    leaves, m, gn_noise = band
    assert update.keys() == leaves.keys()
    held = total = 0
    for path, (keep, u, u_noise) in leaves.items():
        held, total = held + int(keep.sum()), total + keep.size
        if keep.any():
            err = float(np.abs(update[path] - u)[keep].max())
            assert err <= 2 * u_noise, (path, err, u_noise)
    assert held >= 0.9 * total, (held, total)
    assert grad_norm is None or abs(grad_norm - m["grad_norm"]) <= 2 * gn_noise, (grad_norm, m["grad_norm"],
                                                             gn_noise)


def _hold_grads(world_out: dict, arch: str) -> None:
    """Every leaf's sharded gradient (above 1e-4) within twice what a one-ulp
    nudge of every weight, up or down, does to the single-device gradient."""
    cfg, params, data = _setup(arch)
    batch = _batch(data, 0)
    grads = _grads(cfg, params, batch)
    nudges = [_grads(cfg, params, batch, nudge=float(d)) for d in ("inf", "-inf")]
    for path, g in grads.items():
        if np.abs(g).max() > 1e-4:
            got = world_out[f"{arch}:grad:{path}"]
            moved = max(np.abs(n[path] - g).max() for n in nudges)
            assert np.abs(got - g).max() <= 2 * moved, path


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _world_step(got: dict, arch: str) -> dict:
    return {k.split(":", 1)[1]: v for k, v in got.items() if k.startswith(arch + ":/")}


@functools.lru_cache(maxsize=None)
def _step0(arch):
    """(the seed-0 weights, the single-device step 0's band from them)."""
    cfg, params, data = _setup(arch)
    band = _band(cfg, params, make_optimizer("adamw", LR).init(params), 0, _batch(data, 0))
    return _leaves(params), band


def _update(after: dict, before: dict) -> dict:
    return {k: v - before[k] for k, v in after.items()}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_one_device(runs, arch):
    got = _get(runs, "wide")
    _hold_grads(got, arch)
    before, band = _step0(arch)
    _within_band(band, _update(_world_step(got, arch), before),
                 float(got[f"{arch}:grad_norm"]))
    loss, want = float(got[f"{arch}:loss"]), band[1]["loss"]
    assert abs(loss - want) < 5e-3 * max(1.0, abs(want))


@pytest.mark.parametrize("arch", REF_MESH_ARCHS)
def test_sharded_train_step_matches_the_reference_on_a_mesh(runs, arch):
    """The port's step on its (2, 4) world against the reference's on its
    (2, 4) mesh, from the same weights and batch: the loss to 1e-5 and
    ``grad_norm`` to 1e-4 relative, and the reference's update in the band
    the port's is held to."""
    got, r = _get(runs, "wide"), _get(runs, "ref")
    assert float(got[f"{arch}:loss"]) == pytest.approx(float(r[f"{arch}:loss"]), rel=1e-5)
    assert float(got[f"{arch}:grad_norm"]) == pytest.approx(float(r[f"{arch}:grad_norm"]),
                                                            rel=1e-4)
    before, band = _step0(arch)
    _within_band(band, _update(_world_step(r, arch), before), None)


@pytest.mark.parametrize("world", ["train", "elastic"])
def test_sharded_moe_gradients_match_one_device(runs, world):
    """kimi-k2 reduced (8 experts, top-2, a shared expert): its MoE layers
    through the weight-stationary body on (2, 4), through ``_ep_body`` on
    (1, 4), under the sharded step's autograd."""
    _hold_grads(_get(runs, "wide" if world == "train" else "narrow"), MOE_ARCH)


@pytest.mark.parametrize("case", HEAD_CASES)
def test_sharded_loss_gradients_match_one_device(runs, case):
    """The head and CE on each rank's own tokens (``model._head_ce``) under
    the sharded step's autograd on (2, 4), reduced granite: at a vocabulary
    of 258, which 4 does not divide (the weight gathered, each rank's B/2 x
    S/4 tokens), and at a train length of 30, which 4 does not divide (the
    vocab-parallel CE over ``model``).  deepseek-v3's MTP head, which runs
    the head twice, is held with the train step (``TRAIN_ARCHS``)."""
    _hold_grads(_get(runs, "wide"), case)


# ---------------------------------------------------------------------------
# Elastic restore, and a fault in a world
# ---------------------------------------------------------------------------


def _elastic(runs) -> list[dict]:
    return json.loads(str(_get(runs, "narrow")["elastic:ranks"]))


def _ckpt(runs, step: int, template):
    return restore_tree(os.path.join(runs[0], "ckpt"), step, template, device="cpu")


def _held_from_checkpoint(runs, step: int):
    """Hold the narrow world's ``step`` to one device from its checkpoint of
    ``step - 1``: returns (the world's loss, the single-device loss)."""
    arch = TRAIN_ARCHS[0]
    cfg, _, data = _setup(arch)
    params, state = _ckpt(runs, step - 1, runs[2])
    after, _ = _ckpt(runs, step, runs[2])
    band = _band(cfg, params, state, step, _batch(data, step))
    (_, loss, grad_norm), = [r for r in _elastic(runs)[0]["ran"] if r[0] == step]
    _within_band(band, _update(_leaves(after), _leaves(params)), grad_norm)
    return loss, band[1]["loss"]


def test_elastic_restore_resumes_on_another_world(runs):
    """Step 1 of the (2, 2) world, resumed from one process's checkpoint of
    step 0, against the single-device step 1 from that checkpoint."""
    ranks = _elastic(runs)
    assert all(r["placed"] == "DTensor" for r in ranks)
    assert [s for s, _ in ranks[0]["history"]] == [1, 2]          # steps 1 and 2 only
    loss, want = _held_from_checkpoint(runs, 1)
    assert abs(loss - want) < 5e-3 * max(1.0, abs(want))


def test_a_fault_in_a_world_resumes_every_rank_at_one_step(runs):
    """Every rank meets the fault before step 2, restores the step rank 0
    names (step 1, written asynchronously by rank 0) and runs steps 1 and 2
    once each; step 2 matches one device from the world's checkpoint of
    step 1."""
    ranks = _elastic(runs)
    assert len(ranks) == 4
    assert all(r["restarts"] == 1 for r in ranks)
    assert all([s for s, *_ in r["ran"]] == [1, 2] for r in ranks)
    assert all(r["ran"] == ranks[0]["ran"] and r["history"] == ranks[0]["history"]
               for r in ranks)
    loss, want = _held_from_checkpoint(runs, 2)
    assert abs(loss - want) < 5e-3 * max(1.0, abs(want))


def test_placed_init_draws_each_ranks_block(runs):
    """``init_params(..., mesh=)`` on a (2, 2) world: every rank's block of
    every leaf equals what ``distribute_params`` cuts from the whole draw."""
    assert json.loads(str(_get(runs, "narrow")["placed_init:bad"])) == [[]] * 4
