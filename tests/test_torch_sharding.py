"""The port's sharded DSE axes and sharding rules against the reference.

The engine's ``"configs"`` and ``"lanes"`` axes run in-process with n = 2, 4
and 8 shards on the CPU (the counterpart of the reference's forced host
devices): fastchar's partials, fastapp's primitives and the GA sweep must be
bit-identical to the port unsharded and to the reference: characterization
to its unsharded XLA twins, application BEHAV to its numpy oracle, and each
sweep lane's hypervolume checkpoint to its oracle on the lane's archive.  The rule tables need no world: for every
arch, mesh and shape kind each parameter leaf's resolved spec equals the
reference's, and its DTensor placements are what that spec means.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.apps import APPLICATIONS as REF_APPS  # noqa: E402
from repro.configs.registry import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.registry import get_arch as ref_get_arch  # noqa: E402
from repro.configs.registry import rules_for as ref_rules_for  # noqa: E402
from repro.core.fastchar import behav_metrics_jax  # noqa: E402
from repro.core.moo import hypervolume_2d as ref_hypervolume_2d  # noqa: E402
from repro.core.operator_model import spec_for as ref_spec_for  # noqa: E402
from repro.models.model import model_spec as ref_model_spec  # noqa: E402
from repro.models.sharding import named_sharding  # noqa: E402
from repro.models.spec import _leaf_paths as ref_leaf_paths  # noqa: E402

from repro_torch.apps import APPLICATIONS
from repro_torch.apps.fastapp import multi_app_behav_torch
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_arch, rules_for
from repro_torch.core.engine import SHARD_AXES, ExecutionContext
from repro_torch.core.fastchar import behav_metrics_torch
from repro_torch.core.fastmoo import CompiledNSGA2
from repro_torch.core.operator_model import spec_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import model_spec
from repro_torch.models.sharding import BASE_RULES, constrain, mesh_spec, spec_placements
from repro_torch.models.spec import _leaf_paths
from repro_torch.obs.telemetry import Telemetry

MESH_SIZES = (2, 4, 8)


def _ctx(n=None, **kw):
    return ExecutionContext(device="cpu", n_devices=n, **kw)


# ---------------------------------------------------------------------------
# The engine's validation (ref tests/test_engine.py:48-81)
# ---------------------------------------------------------------------------


class TestEngineValidation:
    def test_defaults_shard_nothing(self):
        ctx = _ctx()
        assert ctx.device_count == 1 and ctx.shard_axes == SHARD_AXES
        assert not ctx.shards("configs") and not ctx.shards("lanes")

    def test_shards_names_axes(self):
        ctx = _ctx(4, shard_axes=("lanes",))
        assert ctx.shards("lanes") and not ctx.shards("configs")
        assert ctx.devices() == ["cpu"] * 4
        with pytest.raises(ValueError, match="unknown shard axis"):
            ctx.shards("batch")

    def test_a_single_axis_string_is_a_tuple(self):
        assert _ctx(2, shard_axes="configs").shard_axes == ("configs",)

    @pytest.mark.parametrize("axes", [("configs", "configs"), ("batch",)])
    def test_axes_must_be_distinct_known_names(self, axes):
        with pytest.raises(ValueError, match="distinct names"):
            _ctx(2, shard_axes=axes)

    @pytest.mark.parametrize("n", [0, -1, 1.5])
    def test_n_devices_must_be_positive(self, n):
        with pytest.raises(ValueError, match="positive int"):
            _ctx(n)

    def test_numpy_backend_cannot_shard(self):
        with pytest.raises(ValueError, match="backend='torch'"):
            ExecutionContext(backend="numpy", n_devices=2)

    def test_empty_axes_with_devices_raise(self):
        with pytest.raises(ValueError, match="nothing to shard"):
            _ctx(2, shard_axes=())

    def test_more_cards_than_exist_raise_at_construction(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="1 CUDA devices"):
            ExecutionContext(device="cuda", n_devices=2)
        assert ExecutionContext(device="cuda", n_devices=1).device_count == 1

    def test_shard_context_is_unsharded_on_its_device(self):
        sc = _ctx(4, kernel_impl="entry").shard_context(2)
        assert sc.n_devices is None and sc.kernel_impl == "entry" and sc.device == "cpu"


# ---------------------------------------------------------------------------
# Config-sharded characterization (fastchar D axis)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def char_batch():
    spec = spec_for(8)
    cfgs = np.random.default_rng(0).integers(0, 2, (64, spec.n_luts)).astype(np.uint8)
    base = {impl: behav_metrics_torch(spec, cfgs, impl=impl, ctx=_ctx())
            for impl in ("table", "entry", "plain")}
    ref = {"xla": behav_metrics_jax(spec, cfgs, impl="xla"),
           "entry": behav_metrics_jax(spec, cfgs, impl="entry")}
    return spec, cfgs, base, ref


def _same(a: dict, b: dict, n: int | None = None) -> None:
    for k in a:
        np.testing.assert_array_equal(a[k][:n], b[k], err_msg=k)


@pytest.mark.parametrize("n_dev", MESH_SIZES)
@pytest.mark.parametrize("impl", ["table", "entry", "plain"])
def test_sharded_characterization_bit_identical(char_batch, impl, n_dev):
    spec, cfgs, base, ref = char_batch
    got = behav_metrics_torch(spec, cfgs, impl=impl, ctx=_ctx(n_dev))
    _same(base[impl], got)
    twin = ref["entry"] if impl == "entry" else ref["xla"]
    for k in ("AVG_ABS_ERR", "PROB_ERR", "MAX_ABS_ERR", "MSE"):
        np.testing.assert_array_equal(twin[k], got[k], err_msg=k)
    np.testing.assert_allclose(twin["AVG_ABS_REL_ERR"], got["AVG_ABS_REL_ERR"], rtol=1e-6)


@pytest.mark.parametrize("n_dev", MESH_SIZES)
def test_odd_batch_pads_onto_the_shards(char_batch, n_dev):
    spec, cfgs, base, _ = char_batch
    got = behav_metrics_torch(spec, cfgs[:37], impl="table", ctx=_ctx(n_dev))
    _same(base["table"], got, 37)


def test_sharded_characterization_batches(char_batch):
    spec, cfgs, base, _ = char_batch
    got = behav_metrics_torch(spec, cfgs, impl="entry", batch_size=20, ctx=_ctx(3))
    _same(base["entry"], got)


def test_fastchar_rebuild_counts_once_per_context_and_bucket(char_batch):
    spec, cfgs, _, _ = char_batch
    tel = Telemetry()
    ctx = _ctx(4, telemetry=tel)
    for d in (64, 60, 64):            # 60 and 64 share the 64 bucket
        behav_metrics_torch(spec, cfgs[:d], impl="table", ctx=ctx)
    assert tel.counters["shard.rebuild.fastchar"] == 1
    behav_metrics_torch(spec, cfgs[:16], impl="table", ctx=ctx)   # a new bucket
    behav_metrics_torch(spec, cfgs[:16], impl="plain", ctx=ctx)   # a new impl
    assert tel.counters["shard.rebuild.fastchar"] == 3
    other = _ctx(4, telemetry=tel, shard_axes=("configs",))
    behav_metrics_torch(spec, cfgs[:16], impl="table", ctx=other)
    assert tel.counters["shard.rebuild.fastchar"] == 4         # a new context


# ---------------------------------------------------------------------------
# Config-sharded application BEHAV (fastapp D axis)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def app_batch():
    spec = spec_for(8)
    cfgs = np.random.default_rng(1).integers(0, 2, (16, spec.n_luts)).astype(np.uint8)
    apps = [APPLICATIONS[n]() for n in sorted(APPLICATIONS)]
    # the reference's numpy BEHAV of every app on the same configs
    ref = {n: REF_APPS[n]().behav(ref_spec_for(8), cfgs, backend="numpy")
           for n in sorted(APPLICATIONS)}
    return spec, cfgs, apps, {}, ref


@pytest.mark.parametrize("n_dev", MESH_SIZES)
@pytest.mark.parametrize("impl", ["table", "entry", "gemm", "entry_gather", "plain"])
def test_all_apps_sharded_bit_identical(app_batch, impl, n_dev):
    spec, cfgs, apps, base, ref = app_batch
    if impl not in base:
        base[impl] = multi_app_behav_torch(apps, spec, cfgs, ctx=_ctx(kernel_impl=impl))
    tel = Telemetry()
    got = multi_app_behav_torch(apps, spec, cfgs, ctx=_ctx(n_dev, kernel_impl=impl,
                                                          telemetry=tel))
    _same(base[impl], got)
    _same(ref, got)                                       # the reference's numpy twin
    assert tel.counters["shard.rebuild.fastapp"] >= 1     # the sharded path ran


def test_ragged_app_batch_stays_unsharded(app_batch):
    spec, cfgs, apps, *_ = app_batch
    tel = Telemetry()
    base = multi_app_behav_torch(apps, spec, cfgs[:15], ctx=_ctx())
    got = multi_app_behav_torch(apps, spec, cfgs[:15], ctx=_ctx(4, telemetry=tel))
    _same(base, got)
    assert "shard.rebuild.fastapp" not in tel.counters


def test_fastapp_rebuild_counts_once_per_context_and_bucket(app_batch):
    spec, cfgs, apps, *_ = app_batch
    tel = Telemetry()
    ctx = _ctx(2, kernel_impl="table", telemetry=tel)
    mnist = APPLICATIONS["mnist"]()
    multi_app_behav_torch([mnist], spec, cfgs, ctx=ctx)
    first = tel.counters["shard.rebuild.fastapp"]
    multi_app_behav_torch([mnist], spec, cfgs, ctx=ctx)
    assert tel.counters["shard.rebuild.fastapp"] == first == 1
    assert tel.counters["dispatch.fastapp.table"] == 2      # one a call, as unsharded


# ---------------------------------------------------------------------------
# Lane-sharded GA sweep
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sweep():
    w = torch.from_numpy(np.random.default_rng(2).standard_normal((12, 2)).astype(np.float32))
    objs = lambda x: x @ w.to(x.device)  # noqa: E731
    seeds = list(range(12))
    bounds = [(1e9, 1e9) if i % 3 else (0.5, 2.0) for i in range(12)]
    pools = [np.ones((3, 12), np.uint8) if i % 4 == 0 else None for i in range(12)]
    kw = dict(n_bits=12, pop_size=16, n_gen=6, hv_ref=np.array([4.0, 4.0]))
    base = CompiledNSGA2(objs, ctx=_ctx(), **kw).run_sweep(seeds, bounds, pools)
    return objs, seeds, bounds, pools, kw, base


@pytest.mark.parametrize("n_dev", (2, 4, 5, 8))
def test_lane_sharded_sweep_bit_identical(sweep, n_dev):
    objs, seeds, bounds, pools, kw, base = sweep
    tel = Telemetry()
    got = CompiledNSGA2(objs, ctx=_ctx(n_dev, telemetry=tel), **kw).run_sweep(
        seeds, bounds, pools)
    assert len(got) == len(base)
    for a, b in zip(base, got):
        for name in ("population", "objectives", "archive_configs", "archive_objs",
                     "archive_viol"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert a.hv_history == b.hv_history
        # the reference's oracle of each lane's checkpoint: the hypervolume of
        # its feasible archive (the GA's draws are torch's, not jax.random's,
        # so no reference sweep reproduces the lanes bit for bit)
        feasible = b.archive_objs[b.archive_viol <= 0]
        want = ref_hypervolume_2d(feasible, kw["hv_ref"])
        assert want > 0
        np.testing.assert_allclose(b.hv_history[-1][1], want, rtol=1e-5)
    assert tel.counters["shard.rebuild.fastmoo"] == 1


def test_lanes_axis_alone_leaves_configs_unsharded(sweep):
    objs, seeds, bounds, pools, kw, base = sweep
    tel = Telemetry()
    ctx = _ctx(4, shard_axes=("configs",), telemetry=tel)
    got = CompiledNSGA2(objs, ctx=ctx, **kw).run_sweep(seeds, bounds, pools)
    np.testing.assert_array_equal(base[3].population, got[3].population)
    assert "shard.rebuild.fastmoo" not in tel.counters


# ---------------------------------------------------------------------------
# Sharding rules, with no world
# ---------------------------------------------------------------------------

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}


def _expected_placements(names, spec):
    """What a PartitionSpec means as DTensor placements, written out."""
    out = []
    for name in names:
        dims = [i for i, p in enumerate(spec) if p == name or (isinstance(p, tuple)
                                                              and name in p)]
        out.append(f"S({dims[0]})" if dims else "R")
    return out


def _show(placements):
    return [f"S({p.dim})" if p.is_shard() else "R" for p in placements]


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_rules_and_placements_match_the_reference(arch):
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    ref_leaves = dict(ref_leaf_paths(ref_model_spec(ref_cfg)))
    leaves = dict(_leaf_paths(model_spec(cfg)))
    assert leaves.keys() == ref_leaves.keys()
    for sizes, names in MESHES.items():
        amesh = AbstractMesh(sizes, names)
        for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            rules = rules_for(cfg, SHAPES[shape_name], mesh_model=sizes[-1],
                              mesh_data=sizes[-2])
            ref_rules = ref_rules_for(ref_cfg, REF_SHAPES[shape_name],
                                      mesh_model=sizes[-1], mesh_data=sizes[-2])
            assert rules.param_rules == ref_rules.param_rules
            assert rules.act_rules == ref_rules.act_rules
            for path, leaf in leaves.items():
                spec = rules.resolve(leaf.axes)
                ref_spec = ref_rules.resolve(ref_leaves[path].axes)
                assert spec == tuple(ref_spec), (path, spec, ref_spec)
                pruned = mesh_spec(names, sizes, spec, leaf.shape)
                ref_pruned = tuple(named_sharding(amesh, ref_spec, leaf.shape).spec)
                ref_pruned += (None,) * (len(spec) - len(ref_pruned))
                assert pruned == ref_pruned, (path, pruned, ref_pruned)
                got = _show(spec_placements(names, pruned))
                assert got == _expected_placements(names, ref_pruned), path


def test_activation_specs_match_the_reference():
    ref_rules = ref_rules_for(ref_get_arch("granite-3-2b"), REF_SHAPES["decode_32k"])
    rules = rules_for(get_arch("granite-3-2b"), SHAPES["decode_32k"])
    for axes in [("batch", "seq", "embed"), ("batch", "kv_seq", "kv_heads", "head_dim"),
                 ("batch", "seq", "heads", None), ("batch", "res_seq", "vocab")]:
        assert rules.resolve(axes, "act") == tuple(ref_rules.resolve(axes, "act"))
    names, sizes = MESHES[(2, 16, 16)], (2, 16, 16)
    spec = BASE_RULES.resolve(("batch", "seq"), "act")
    assert spec == (("pod", "data"), None)
    assert _show(spec_placements(names, mesh_spec(names, sizes, spec, (64, 8)))) == \
        ["S(0)", "S(0)", "R"]
    # batch 16 takes pod x data only as far as it divides: (2 * 16 > 16)
    assert mesh_spec(names, sizes, spec, (16, 8)) == ("pod", None)
    assert mesh_spec(("data", "model"), (16, 16), spec, (64, 8)) == ("data", None)
    assert PartitionSpec(*spec) == ref_rules.resolve(("batch", "seq"), "act")


def test_constrain_is_a_no_op_off_the_mesh():
    x = torch.ones(2, 3)
    assert constrain(x, BASE_RULES, "batch", "embed") is x


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_whole_world(multi_pod):
    with pytest.raises(RuntimeError, match="needs a world of 512" if multi_pod
                       else "needs a world of 256"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_multi_axis_dims_must_follow_mesh_order():
    with pytest.raises(ValueError, match="mesh's order"):
        spec_placements(("data", "model"), (("model", "data"), None))
