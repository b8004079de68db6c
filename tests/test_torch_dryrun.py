"""The port's dry-run tools against the reference's, on the CPU.

A fake world of 8 ranks (``launch.lowering.fake_world``) backs a (2, 4)
``("data", "model")`` mesh in this process; the reference's specs are
resolved on an ``AbstractMesh`` of the same shape (no devices).  Cells are
the reduced archs at mini shapes (64 tokens x 8 sequences).

* **Placements**: for every arch and each of train, prefill and decode,
  every parameter, optimizer-state, batch and cache leaf's placement equals
  the reference's ``param_shardings`` / ``batch_shardings`` /
  ``cache_shardings`` spec under the same ``rules_for(..., mesh_model=4,
  mesh_data=2)``, and each fake leaf holds this rank's block.
* **Argument bytes**: ``lower_step``'s equal the local shards of those specs
  (exactly), and for internlm2 the reference's
  ``memory_analysis().argument_size_in_bytes`` from 8 host devices on an
  ``AxisType.Auto`` mesh (exactly, train, prefill and decode).
* **Probes**: ``probe_variants`` gives the reference's stage and encoder
  layouts for every arch, ``corrected_costs`` the reference's arithmetic,
  and the extrapolation over the probes equals a full trace exactly (FLOPs,
  bytes, each collective kind, argument bytes) for granite at 3 repeats and
  whisper (its encoder probe), remat on: with the dry-run's probes (a
  stage's repeats doubled) at train, prefill and decode, with the
  reference's (its layer list doubled) at prefill and decode; at train the
  reference's layout counts more (two layers in one remat checkpoint;
  ``launch.costprobe``).
* **FLOPs**: a one-device ``lower_step`` counts what ``FlopCounterMode``
  counts over the real CPU step (train, prefill, decode), and the counter
  counts local ops: a replicated matmul all its FLOPs, one sharded 8 ways
  1/8, and a redistribute's collectives by kind.
* **K7 and K8 as ops**: their fake implementations give the launch's
  shapes, dtypes, devices and layout (K7 causal and not, Sq != Skv, head
  widths 64/112/128; K8 bf16 and f32, with and without ``init_state``), the
  FLOP formulas are the registry's ``cost_fn``, and the gradients through
  ``FlashAttentionFn`` and ``SSDScanFn`` equal the plain versions' autodiff
  exactly.
* **Sharded serving** on the gloo (2, 4) world (``tests/torch_world.py``,
  job ``serve``): the sharded prefill and two decode steps, the decode cache
  placed by the decode rules (sequence over ``model``) and kept so by the
  in-place writes.  Their f32 logits equal the one-device steps' within
  1e-5, or, where a one-ulp nudge of every weight moves the one-device
  logits by more (kimi-k2, the VLM and jamba reduced: by 2.6e-5 to 9.4e-4),
  within twice that nudge; and the reference's sharded steps on an
  ``AxisType.Auto`` (2, 4) mesh within the band the port's reduced archs
  hold against the reference (``atol=2e-3, rtol=1e-3``,
  ``tests/test_torch_families.py``).
* **CLI**: ``dryrun --list`` prints the reference's cells and statuses;
  ``report``'s tables equal the reference's on synthetic records but for the
  HBM column (80 GB against 16 GiB); a mini cell's record has the
  reference's keys.
"""

import io
import json
import math
import os
import subprocess
import sys
import textwrap
from contextlib import redirect_stdout
from dataclasses import replace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.base import ShapeConfig as RefShapeConfig  # noqa: E402
from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.configs.registry import input_specs as ref_input_specs  # noqa: E402
from repro.configs.registry import rules_for as ref_rules_for  # noqa: E402
from repro.launch import costprobe as ref_costprobe  # noqa: E402
from repro.launch import report as ref_report  # noqa: E402
from repro.launch.steps import batch_shardings as ref_batch_shardings  # noqa: E402
from repro.launch.steps import cache_shardings as ref_cache_shardings  # noqa: E402
from repro.models.model import model_spec as ref_model_spec  # noqa: E402
from repro.models.spec import param_shardings as ref_param_shardings  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.optim import make_optimizer as ref_make_optimizer  # noqa: E402

from repro_torch.configs.base import ShapeConfig, StageConfig  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    ARCH_IDS, SHAPES, arch_for_shape, cell_status, get_arch, input_specs, rules_for,
)
from repro_torch.core.engine import ExecutionContext  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels.registry import _flash_cost, _ssd_cost  # noqa: E402
from repro_torch.launch import costprobe, dryrun, report  # noqa: E402
from repro_torch.launch.lowering import COLLECTIVES, StepCounter, fake_world, lower_step  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    abstract_cache, batch_placements, make_decode_step, make_prefill_step, make_train_step,
)
from repro_torch.models.model import model_spec  # noqa: E402
from repro_torch.models.spec import _leaf_paths, abstract_params, init_params  # noqa: E402
from repro_torch.optim import cosine_schedule, make_optimizer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_world import (  # noqa: E402
    SERVE_ARCHS, SERVE_BATCH, SERVE_CAP, SERVE_DECODES, SERVE_PROMPT, serve_inputs,
)

KINDS = ("train", "prefill", "decode")
SEQ, BATCH = 64, 8                      # the mini shapes
NAMES = ("data", "model")
AMESH = AbstractMesh((2, 4), NAMES)
CPU = ExecutionContext(device="cpu")
TIMEOUT = 300                           # seconds, each subprocess
ATOL, RTOL = 2e-3, 1e-3                 # the port's reduced archs against the reference


def _shape(kind):
    return ShapeConfig(f"mini_{kind}", SEQ, BATCH, kind)


def _ref_shape(kind):
    return RefShapeConfig(f"mini_{kind}", SEQ, BATCH, kind)


def _rules(arch, kind):
    return rules_for(get_arch(arch).reduced(), _shape(kind), mesh_model=4, mesh_data=2)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


# ---------------------------------------------------------------------------
# Subprocesses: the gloo world's sharded serving and the reference's sharded
# steps and memory analysis, started with the module and read when needed
# ---------------------------------------------------------------------------

REF_CODE = """
    import os, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.configs.base import ShapeConfig
    from repro.configs.registry import get_arch, rules_for
    from repro.launch.lowering import lower_step
    from repro.launch.steps import (batch_shardings, cache_shardings, make_decode_step,
                                    make_prefill_step)
    from repro.models.model import model_spec
    from repro.models.sharding import named_sharding, set_mesh
    from repro.models.spec import param_shardings

    out_dir = os.environ["OUT_DIR"]
    prompt, cap, bsz, ndec = (int(v) for v in os.environ["SERVE_SHAPE"].split(","))
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}

    cfg = get_arch("internlm2-1.8b").reduced()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig("mini_" + kind, 64, 8, kind)
        rules = rules_for(cfg, shape, mesh_model=4, mesh_data=2)
        mem = lower_step(cfg, shape, mesh, rules).compile().memory_analysis()
        out["args:" + kind] = mem.argument_size_in_bytes

    z = np.load(os.path.join(out_dir, "serve_in.npz"))
    for arch in os.environ["SERVE_ARCHS"].split(","):
        cfg = get_arch(arch).reduced()
        spec = model_spec(cfg)
        load = lambda t, pre: ({k: load(v, pre + "/" + k) for k, v in t.items()}
                               if isinstance(t, dict)
                               else jnp.asarray(z[(arch + pre).replace("/", "|")]))
        params = load(spec, "")
        pre_rules, dec_rules = (rules_for(cfg, ShapeConfig("mini_" + k, cap, bsz, k),
                                          mesh_model=4, mesh_data=2)
                                for k in ("prefill", "decode"))
        toks = jnp.asarray(z[arch + ":tokens"])
        dec = jnp.asarray(z[arch + ":decode_tokens"])
        args = [toks] + ([jnp.asarray(z[arch + ":frontend"])]
                         if arch + ":frontend" in z.files else [])
        with set_mesh(mesh):
            p_sh = param_shardings(spec, pre_rules, mesh)
            in_sh = (p_sh,) + tuple(batch_shardings(pre_rules, mesh, a) for a in args)
            prefill = jax.jit(make_prefill_step(cfg, pre_rules, max_seq=cap),
                              in_shardings=in_sh)
            logits, cache = prefill(jax.device_put(params, p_sh), *args)
            out[arch + ":prefill"] = logits
            c_sh = cache_shardings(cfg, dec_rules, mesh, bsz, cap)
            t_sh = batch_shardings(dec_rules, mesh, dec[:, :1])
            decode = jax.jit(make_decode_step(cfg, dec_rules),
                             in_shardings=(p_sh, c_sh, t_sh, named_sharding(mesh, P())))
            for j in range(ndec):
                logits, cache = decode(jax.device_put(params, p_sh),
                                       jax.device_put(cache, c_sh),
                                       jax.device_put(dec[:, j:j + 1], t_sh),
                                       jnp.int32(prompt + j))
                out[arch + ":decode%d" % j] = logits
    np.savez(os.path.join(out_dir, "ref.npz"), **{k: np.asarray(v) for k, v in out.items()})
"""


class _Run:
    """A subprocess started now and read later (its ``out_path`` npz)."""

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


def _serve_weights(arch):
    cfg = get_arch(arch).reduced()
    return cfg, init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun_world"))
    arrays = {}
    for arch in SERVE_ARCHS:
        cfg, params = _serve_weights(arch)
        for path, v in _leaf_paths(params):
            arrays[f"{arch}{path}".replace("/", "|")] = v.numpy()
        toks, dec, front = serve_inputs(cfg)
        arrays[arch + ":tokens"] = toks.astype(np.int32)
        arrays[arch + ":decode_tokens"] = dec.astype(np.int32)
        if front is not None:
            arrays[arch + ":frontend"] = front
    np.savez(os.path.join(out_dir, "serve_in.npz"), **arrays)
    started = {
        "ref": _Run([sys.executable, "-c", textwrap.dedent(REF_CODE)],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                         JAX_PLATFORMS="cpu", OUT_DIR=out_dir,
                         SERVE_ARCHS=",".join(SERVE_ARCHS),
                         SERVE_SHAPE=f"{SERVE_PROMPT},{SERVE_CAP},{SERVE_BATCH},{SERVE_DECODES}"),
                    os.path.join(out_dir, "ref.npz")),
        "serve": _Run([sys.executable, os.path.join(ROOT, "tests", "torch_world.py"), "serve",
                       "8", out_dir], _env(OMP_NUM_THREADS="1"),
                      os.path.join(out_dir, "serve.npz")),
    }
    yield started
    for run in started.values():
        run.close()


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(8)
    yield init_device_mesh("cpu", (2, 4), mesh_dim_names=NAMES)
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Placements and argument bytes
# ---------------------------------------------------------------------------


def _spec_of(placements, ndim):
    """DTensor placements -> the reference's spec form, one entry a dim."""
    out = []
    for d in range(ndim):
        axes = tuple(n for n, p in zip(NAMES, placements) if p.is_shard(d))
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def _ref_spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _local_bytes(shape, dtype_bytes, spec):
    n = math.prod(shape) * dtype_bytes
    sizes = dict(zip(NAMES, (2, 4)))
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,) if part else ()):
            n //= sizes[a]
    return n


def _check_tree(got, want, prefix):
    """Every leaf's placements and local block against the reference's
    shardings; returns the local bytes the reference's specs give."""
    got, want = dict(_leaf_paths(got)), dict(_leaf_paths_ref(want))
    assert set(got) == set(want), prefix
    total = 0
    for path, leaf in got.items():
        spec = _ref_spec(want[path], leaf.ndim)
        assert _spec_of(leaf.placements, leaf.ndim) == spec, f"{prefix}{path}"
        local = list(leaf.shape)
        for d, part in enumerate(spec):
            for a in (part if isinstance(part, tuple) else (part,) if part else ()):
                local[d] //= dict(zip(NAMES, (2, 4)))[a]
        assert tuple(leaf.to_local().shape) == tuple(local), f"{prefix}{path}"
        total += _local_bytes(tuple(leaf.shape), leaf.element_size(), spec)
    return total


def _leaf_paths_ref(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths_ref(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _cell_trees(arch, kind, mesh):
    """(port trees, reference shardings) of one cell: parameters, optimizer
    state, data inputs and cache, as the dry-run places them."""
    cfg, rcfg = get_arch(arch).reduced(), ref_get_arch(arch).reduced()
    rules = rules_for(cfg, _shape(kind), mesh_model=4, mesh_data=2)
    rrules = ref_rules_for(rcfg, _ref_shape(kind), mesh_model=4, mesh_data=2)
    assert (rules.param_rules, rules.act_rules) == (rrules.param_rules, rrules.act_rules)
    spec, rspec = model_spec(cfg), ref_model_spec(rcfg)
    port = {"params": abstract_params(spec, torch.bfloat16, "cpu", mesh=mesh, rules=rules)}
    ref = {"params": ref_param_shardings(rspec, rrules, AMESH)}
    if kind == "train":
        opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4))
        ropt = ref_make_optimizer(rcfg.optimizer, ref_cosine(3e-4))
        port["state"] = abstract_params(opt.state_spec(spec), torch.bfloat16, "cpu",
                                        mesh=mesh, rules=rules)
        ref["state"] = ref_param_shardings(ropt.state_spec(rspec), rrules, AMESH)
    if kind != "train":
        port["cache"] = abstract_cache(cfg, BATCH, SEQ, device="cpu", mesh=mesh, rules=rules)
        ref["cache"] = ref_cache_shardings(rcfg, rrules, AMESH, BATCH, SEQ)
    specs = input_specs(cfg, _shape(kind))
    rspecs = ref_input_specs(rcfg, _ref_shape(kind))
    data = specs["batch"] if kind == "train" else {k: v for k, v in specs.items()
                                                   if k != "index"}
    rdata = rspecs["batch"] if kind == "train" else {k: v for k, v in rspecs.items()
                                                     if k != "index"}
    return port, ref, data, rdata, batch_placements(rules, mesh, data), \
        ref_batch_shardings(rrules, AMESH, rdata), cfg, rules


CELLS = [(a, k) for a in ARCH_IDS for k in KINDS]


@pytest.mark.parametrize("arch,kind", CELLS, ids=[f"{a}-{k}" for a, k in CELLS])
def test_placements_equal_the_reference(mesh, arch, kind):
    port, ref, data, rdata, place, rplace, *_ = _cell_trees(arch, kind, mesh)
    for name in port:
        _check_tree(port[name], ref[name], f"{arch}:{kind}:{name}")
    assert set(place) == set(rplace)
    for k, pl in place.items():
        assert tuple(data[k].shape) == tuple(rdata[k].shape)
        assert data[k].dtype == getattr(torch, str(rdata[k].dtype))
        assert _spec_of(pl, data[k].dim()) == _ref_spec(rplace[k], data[k].dim()), k


# lower_step's argument bytes: every arch at the serving kinds, three archs at train
BYTE_CELLS = [(a, k) for a in ARCH_IDS for k in ("prefill", "decode")] + [
    ("granite-3-2b", "train"), ("mamba2-130m", "train"), ("kimi-k2-1t-a32b", "train")]


@pytest.mark.parametrize("arch,kind", BYTE_CELLS, ids=[f"{a}-{k}" for a, k in BYTE_CELLS])
def test_argument_bytes_are_the_reference_specs_local_shards(mesh, arch, kind):
    port, ref, data, rdata, place, rplace, cfg, rules = _cell_trees(arch, kind, mesh)
    want = sum(_check_tree(port[n], ref[n], n) for n in port if n != "cache" or
               kind == "decode")
    want += sum(_local_bytes(tuple(v.shape), v.dtype.itemsize, _ref_spec(rplace[k], v.ndim))
                for k, v in rdata.items())
    want += 4 if kind in ("train", "decode") else 0   # the step counter / the index
    rec = lower_step(cfg, _shape(kind), mesh, rules, device="cpu")
    assert rec["argument_size_in_bytes"] == want
    assert rec["peak_bytes"] >= want and rec["flops"] > 0 and rec["coll_total"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_internlm2_argument_bytes_equal_the_references_memory_analysis(mesh, runs, kind):
    cfg = get_arch("internlm2-1.8b").reduced()
    rec = lower_step(cfg, _shape(kind), mesh, _rules("internlm2-1.8b", kind), device="cpu")
    assert rec["argument_size_in_bytes"] == int(runs["ref"].result()[f"args:{kind}"])


# ---------------------------------------------------------------------------
# Cost probes
# ---------------------------------------------------------------------------


def _layouts(variants):
    return {tag: (tuple((s.repeats, tuple(s.layers)) for s in c.stages),
                  None if c.encoder is None else (c.encoder.n_layers, c.encoder.n_ctx),
                  c.unroll_loops, c.attn_q_chunk, c.attn_kv_chunk)
            for tag, c in variants.items()}


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_probe_variants_are_the_reference_layouts(arch):
    for shape in ("train_4k", "prefill_32k"):
        cfg = arch_for_shape(get_arch(arch), SHAPES[shape])
        from repro.configs.base import SHAPES as RSHAPES
        from repro.configs.registry import arch_for_shape as ref_arch_for_shape

        rcfg = ref_arch_for_shape(ref_get_arch(arch), RSHAPES[shape])
        assert (cfg.max_seq, cfg.causal_block_skip) == (rcfg.max_seq, rcfg.causal_block_skip)
        assert _layouts(costprobe.probe_variants(cfg)) == \
            _layouts(ref_costprobe.probe_variants(rcfg))


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_corrected_costs_arithmetic_equals_the_reference(arch):
    cfg, rcfg = get_arch(arch), ref_get_arch(arch)
    rng = np.random.default_rng(sum(map(ord, arch)))
    tags = list(costprobe.probe_variants(cfg))
    # P1 below and above each P2 on some keys: the correction clips at 0
    measures = {t: {k: float(rng.integers(0, 10**6)) for k in costprobe.MEASURE_KEYS}
                for t in tags}
    assert costprobe.corrected_costs(cfg, measures) == \
        ref_costprobe.corrected_costs(rcfg, measures)


# (arch, kind, how a probe doubles a stage): the dry-run's repeats at every
# kind, remat on; the reference's doubled layer lists at the serving kinds
PROBE_CELLS = [(a, k, "repeats") for a in ("granite-3-2b", "whisper-medium")
               for k in KINDS] + [("granite-3-2b", "prefill", "layers"),
                                  ("granite-3-2b", "decode", "layers"),
                                  ("whisper-medium", "prefill", "layers")]


@pytest.mark.parametrize("arch,kind,double", PROBE_CELLS,
                         ids=[f"{a}-{k}-{d}" for a, k, d in PROBE_CELLS])
def test_probe_extrapolation_equals_a_full_trace(mesh, arch, kind, double):
    cfg = get_arch(arch).reduced()
    cfg = replace(cfg, stages=tuple(StageConfig(repeats=3, layers=s.layers)
                                    for s in cfg.stages))
    assert cfg.remat
    shape = ShapeConfig(f"mini_{kind}", 32, BATCH, kind)
    rules = rules_for(cfg, shape, mesh_model=4, mesh_data=2)
    full = costprobe.measure(lower_step(cfg, shape, mesh, rules, device="cpu"))
    probes = {tag: costprobe.measure(lower_step(p, shape, mesh, rules, device="cpu"))
              for tag, p in costprobe.probe_variants(cfg, double=double).items()}
    assert set(probes) == ({"P1", "P2s0", "P2enc"} if cfg.encoder else {"P1", "P2s0"})
    got = costprobe.corrected_costs(cfg, probes)
    for key in ("flops", "bytes", "coll_total", "argument_size_in_bytes") + tuple(
            f"coll_{k}" for k in COLLECTIVES):
        assert got[key] == full[key], key
    assert full["flops"] > probes["P1"]["flops"] > 0


def test_doubled_layer_lists_overcount_a_remat_train_step(mesh):
    """Why the dry-run doubles repeats: the reference's layout puts two
    layers in one remat checkpoint, so a train cell's extrapolation counts
    more FLOPs and a higher peak than the full trace."""
    cfg = get_arch("granite-3-2b").reduced()
    cfg = replace(cfg, stages=(StageConfig(repeats=3, layers=cfg.stages[0].layers),))
    shape = ShapeConfig("mini_train", 32, BATCH, "train")
    rules = rules_for(cfg, shape, mesh_model=4, mesh_data=2)
    full = costprobe.measure(lower_step(cfg, shape, mesh, rules, device="cpu"))
    probes = {tag: costprobe.measure(lower_step(p, shape, mesh, rules, device="cpu"))
              for tag, p in costprobe.probe_variants(cfg).items()}
    got = costprobe.corrected_costs(cfg, probes)
    assert got["flops"] > full["flops"] and got["peak_bytes"] > full["peak_bytes"]


# ---------------------------------------------------------------------------
# FLOPs: the local ops, and the real step's count on one device
# ---------------------------------------------------------------------------


def _real_step(cfg, kind):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.data.synthetic import SyntheticLM

    shape = ShapeConfig("s", 32, 4, "train" if kind == "train" else "prefill")
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLM(cfg, shape).batch(0).items()}
    counter = FlopCounterMode(display=False)
    if kind == "train":
        opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4))
        state = opt.init(params)
        with counter:
            make_train_step(cfg, opt, ctx=CPU)(params, state, 0, batch)
    elif kind == "prefill":
        with counter:
            make_prefill_step(cfg, 32, ctx=CPU)(params, batch["tokens"])
    else:
        _, cache = make_prefill_step(cfg, 32, ctx=CPU)(params, batch["tokens"][:, :8])
        with counter:
            make_decode_step(cfg, ctx=CPU)(params, cache, batch["tokens"][:, 8:9], 31)
    return counter.get_total_flops()


@pytest.mark.parametrize("arch,kind", [("granite-3-2b", k) for k in KINDS] +
                         [("mamba2-130m", "train"), ("kimi-k2-1t-a32b", "prefill")])
def test_one_device_flops_equal_the_flop_counter_on_the_real_step(arch, kind):
    cfg = get_arch(arch).reduced()
    shape = ShapeConfig("s", 32, 4, kind)
    rec = lower_step(cfg, shape, None, rules_for(cfg, shape), device="cpu",
                     dtype=torch.float32)
    assert rec["flops"] == _real_step(cfg, kind) > 0
    assert rec["coll_total"] == 0


def test_the_counter_counts_local_ops_and_collectives(mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    m, k, n = 64, 32, 128
    with FakeTensorMode(allow_non_fake_inputs=True):
        def put(shape, pl):
            return DTensor.from_local(torch.empty(shape), mesh, pl, run_check=False)

        a, w = put((m, k), [Replicate()] * 2), put((k, n), [Replicate()] * 2)
        with StepCounter() as c:
            a @ w
        assert c.flops == 2 * m * k * n and c.coll["all-gather"] == 0
        a8 = put((m // 2, k), [Shard(0), Replicate()])
        w8 = put((k, n // 4), [Replicate(), Shard(1)])
        with StepCounter() as c, FlopCounterMode(display=False) as g:
            y = a8 @ w8
        assert c.flops * 8 == 2 * m * k * n == g.get_total_flops()   # local vs global
        assert sum(c.coll.values()) == 0
        with StepCounter() as c:
            y.redistribute(mesh, [Replicate(), Replicate()])
        assert c.coll["all-gather"] >= (m // 2) * (n // 4) * 4
        assert c.coll["all-reduce"] == c.coll["reduce-scatter"] == 0
        p = put((m, n), [Partial(), Replicate()])
        with StepCounter() as c:
            p.redistribute(mesh, [Replicate(), Replicate()])
        assert c.coll["all-reduce"] == m * n * 4


# ---------------------------------------------------------------------------
# K7 and K8 as traceable ops
# ---------------------------------------------------------------------------

K7_CASES = [(causal, sq, skv, hd, dt) for causal, sq, skv in
            ((True, 40, 40), (False, 40, 40), (False, 24, 70), (True, 16, 48))
            for hd in (64, 112, 128) for dt in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("causal,sq,skv,hd,dtype", K7_CASES)
def test_k7_op_fake_gives_the_launch_outputs_and_cost(causal, sq, skv, hd, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, h, g = 2, 8, 2
    with FakeTensorMode():
        q = torch.empty(b, sq, h, hd, dtype=dtype, device="cuda").transpose(1, 2)
        k = torch.empty(b, skv, g, hd, dtype=dtype, device="cuda").transpose(1, 2)
        v = torch.empty(b, skv, g, hd, dtype=dtype, device="cuda").transpose(1, 2)
        with FlopCounterMode(display=False) as fc:
            out = fa.flash_attention(q, k, v, causal=causal, q_offset=skv - sq)
        want = torch.empty_like(q)
        assert (out.shape, out.dtype, out.device, out.stride()) == \
            (want.shape, want.dtype, want.device, want.stride())
    assert fc.get_total_flops() == _flash_cost(b=b, h=h, sq=sq, skv=skv, hd=hd,
                                               causal=causal)["flops"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_state", [False, True])
def test_k8_op_fake_gives_the_launch_outputs_and_cost(dtype, with_state):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    b, s, h, g, p, n = 2, 72, 8, 2, 16, 32
    with FakeTensorMode():
        x = torch.empty(b, s, h, p, dtype=dtype, device="cuda")
        dt = torch.empty(b, s, h, device="cuda")
        a = torch.empty(h, device="cuda")
        bm = torch.empty(b, s, g, n, dtype=dtype, device="cuda")
        init = torch.empty(b, h, p, n, device="cuda") if with_state else None
        with FlopCounterMode(display=False) as fc:
            y, st = ss.ssd_scan(x, dt, a, bm, bm, chunk=32, init_state=init)
        assert (y.shape, y.dtype, y.device) == ((b, s, h, p), dtype, x.device)
        assert (st.shape, st.dtype, st.device) == ((b, h, p, n), torch.float32, x.device)
    assert fc.get_total_flops() == _ssd_cost(b=b, s=s, h=h, g=g, p=p, n=n, chunk=32)["flops"]


def test_gradients_through_the_autograd_functions_are_the_plain_versions():
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64).requires_grad_()

    q, k, v = rand(2, 4, 12, 16), rand(2, 2, 20, 16), rand(2, 2, 20, 16)
    got = torch.autograd.grad(fa.FlashAttentionFn.apply(q, k, v, False, None, 0, 20).sum(),
                              (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(q, k, v, causal=False).sum(),
                               (q, k, v))
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    x, dt, bm, cm = rand(2, 24, 4, 8), rand(2, 24, 4), rand(2, 24, 1, 8), rand(2, 24, 1, 8)
    a, init = rand(4), rand(2, 4, 8, 8)
    sp_ = torch.nn.functional.softplus
    yg, sg = ss.SSDScanFn.apply(x, sp_(dt), -a.exp(), bm, cm, 8, init)
    got = torch.autograd.grad(yg.sum() + sg.sum(), (x, dt, a, bm, cm, init))
    yp, sp = ss.ssd_scan_plain(x, sp_(dt), -a.exp(), bm, cm, chunk=8, init_state=init)
    want = torch.autograd.grad(yp.sum() + sp.sum(), (x, dt, a, bm, cm, init))
    for x_, y_ in zip(got, want):
        assert torch.equal(x_, y_)


# ---------------------------------------------------------------------------
# Sharded serving on the gloo world
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_device():
    """Per arch: the one-device steps' logits and the largest move a one-ulp
    nudge of every weight (up or down) makes to each."""
    from repro_torch.optim import tree_map

    out = {}
    for arch in SERVE_ARCHS:
        cfg, params = _serve_weights(arch)
        toks, dec, front = serve_inputs(cfg)
        runs = []
        for nudge in (0.0, math.inf, -math.inf):
            p = params if not nudge else tree_map(
                lambda t, to=torch.tensor(nudge): torch.nextafter(t, to), params)
            logits, cache = make_prefill_step(cfg, SERVE_CAP, ctx=CPU)(
                p, torch.as_tensor(toks), None if front is None else torch.as_tensor(front))
            got = [logits.numpy()]
            for j in range(SERVE_DECODES):
                logits, cache = make_decode_step(cfg, ctx=CPU)(
                    p, cache, torch.as_tensor(dec[:, j:j + 1]), SERVE_PROMPT + j)
                got.append(logits.numpy())
            runs.append(got)
        band = [max(np.abs(r[i] - runs[0][i]).max() for r in runs[1:])
                for i in range(len(runs[0]))]
        out[arch] = (runs[0], band)
    return out


STEPS = ["prefill"] + [f"decode{j}" for j in range(SERVE_DECODES)]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_equals_one_device(runs, one_device, arch):
    got = runs["serve"].result()
    want, band = one_device[arch]
    for i, step in enumerate(STEPS):
        err = np.abs(got[f"{arch}:{step}"] - want[i]).max()
        assert err <= max(1e-5, 2 * band[i]), (step, err, band[i])
    assert bool(got[f"{arch}:cache_placed"]) and bool(got[f"{arch}:kv_seq_sharded"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_matches_the_references_sharded_steps(runs, arch):
    got, ref = runs["serve"].result(), runs["ref"].result()
    for step in STEPS:
        want = ref[f"{arch}:{step}"]
        np.testing.assert_allclose(got[f"{arch}:{step}"].reshape(want.shape), want,
                                   atol=ATOL, rtol=RTOL, err_msg=step)


# ---------------------------------------------------------------------------
# The CLI and the report
# ---------------------------------------------------------------------------


def test_list_equals_the_references_cells_and_statuses():
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list", "--all"],
                         capture_output=True, text=True, timeout=TIMEOUT, cwd=ROOT,
                         env=_env(JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main(["--list", "--all"]) == 0
    assert buf.getvalue().splitlines() == ref.stdout.splitlines()
    assert len(buf.getvalue().splitlines()) == 10 * 4 * 2
    assert all(cell_status(a, s) == "run" or s == "long_500k" for a in ARCH_IDS for s in SHAPES)


def _synthetic_records():
    recs, rng = {}, np.random.default_rng(3)
    for i, a in enumerate(ARCH_IDS):
        for s in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                if (i + len(s)) % 7 == 0:
                    continue                                   # MISSING
                st = cell_status(a, s)
                if st == "run" and (i + len(mesh)) % 5 == 0:
                    st = "FAIL: RuntimeError: a synthetic failure of some length"
                r = {"arch": a, "shape": s, "mesh": mesh, "status": st}
                if st == "ok" or st == "run":
                    t = [float(x) for x in rng.random(3) * 10.0 ** rng.integers(-4, 1, 3)]
                    need = int(rng.integers(10**8, 2 * 10**11))
                    r.update(status="ok", hbm_need_bytes=need, t_compile_s=t[0] * 100,
                             t_trace_s=t[0] * 100, fits_v5e_hbm=need <= 16 * 1024**3,
                             fits_h100_hbm=need <= 80 * 10**9, t_compute_s=t[0],
                             t_memory_s=t[1], t_collective_s=t[2],
                             bottleneck=["compute", "memory", "collective"][int(np.argmax(t))],
                             model_flops=float(rng.random() * 1e15),
                             useful_fraction=float(rng.random()),
                             mfu_bound=float(rng.random()))
                recs[(a, s, mesh)] = r
    return recs


def test_report_tables_equal_the_references_but_the_hbm_column(tmp_path):
    recs = _synthetic_records()

    def mask(table):   # the header's HBM and seconds names, and the fits column
        lines = table.splitlines()
        rows = [ln.split("|") for ln in lines[2:]]
        return [[c for j, c in enumerate(r) if j != 6] for r in rows]

    got, want = report.dryrun_table(recs), ref_report.dryrun_table(recs)
    assert mask(got) == mask(want)
    assert "fits 80G" in got.splitlines()[0] and "trace s" in got.splitlines()[0]
    assert report.roofline_table(recs) == ref_report.roofline_table(recs)
    assert report.interesting_cells(recs) == ref_report.interesting_cells(recs)
    for r in recs.values():
        (tmp_path / f"{r['arch']}__{r['shape']}__{r['mesh']}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == ref_report.load(str(tmp_path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert report.main(["--dir", str(tmp_path)]) == 0
    assert "## Dry-run grid" in buf.getvalue() and "## Hillclimb candidates" in buf.getvalue()


REF_RECORD_KEYS = {
    "status", "t_lower_s", "t_probe_s", "probe_corrected", "arch", "shape", "mesh", "chips",
    "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "hlo_flops", "hlo_bytes",
    "coll_bytes", "bytes_per_device", "model_flops", "useful_fraction", "mfu_bound",
    "raw_flops", "raw_bytes", "raw_coll_bytes", "coll_breakdown", "params_total",
    "params_active", "temp_size_in_bytes", "argument_size_in_bytes", "hbm_need_bytes",
}   # the reference's, less its compile time, its v5e check and XLA's output/alias sizes


@pytest.mark.parametrize("probe", [False, True])
def test_a_mini_cells_record_has_the_references_keys(mesh, probe):
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", False, verbose=False, probe=probe,
                          device="cpu", mesh=mesh, cfg=get_arch("granite-3-2b").reduced())
    assert REF_RECORD_KEYS <= set(rec)
    assert {"t_trace_s", "fits_h100_hbm"} <= set(rec) and "t_compile_s" not in rec
    assert rec["status"] == "ok" and rec["chips"] == 8 and rec["probe_corrected"] is probe
    assert rec["hlo_flops"] > 0 and rec["hbm_need_bytes"] >= rec["argument_size_in_bytes"]
    assert (rec["raw_flops"] is None) is probe
    assert set(rec["coll_breakdown"]) == set(COLLECTIVES)
    skip = dryrun.run_cell("granite-3-2b", "long_500k", True, device="cpu")
    assert skip["status"].startswith("skip") and skip["mesh"] == "2x16x16"
