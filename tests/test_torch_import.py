"""The PyTorch port stands alone: no JAX, nothing of the reference package."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import APPLICATIONS, characterized_dataset_multi
from repro_torch import service
from repro_torch.core import dse, fastchar, miqcp
from repro_torch.core.dataset import Dataset, build_training_dataset, characterize
from repro_torch.core.engine import ENGINE_MENUS, ExecutionContext, as_context
from repro_torch.core.metrics import behav_metrics
from repro_torch.core.moo import nsga2
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.configs.registry import get_arch
from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.launch import serve, train
from repro_torch.models.model import model_spec
from repro_torch.models.spec import init_params

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_neither_jax_nor_reference(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_package_imports_with_jax_and_reference_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch, repro_torch.convert\n"
        "import repro_torch.core.dse, repro_torch.core.fastchar, repro_torch.core.fastmoo\n"
        "import repro_torch.kernels.char_kernels, repro_torch.kernels.moo_kernels\n"
        "import repro_torch.apps, repro_torch.apps.fastapp, repro_torch.kernels.app_kernels\n"
        "import repro_torch.kernels.axo_matmul, repro_torch.kernels.flash_attention\n"
        "import repro_torch.configs.registry, repro_torch.models.model, repro_torch.axo\n"
        "import repro_torch.data.synthetic, repro_torch.launch.steps, repro_torch.launch.serve\n"
        "import repro_torch.models.ssm, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.configs.mamba2_130m, repro_torch.models.moe\n"
        "import repro_torch.configs.internlm2_1_8b, repro_torch.configs.starcoder2_3b\n"
        "import repro_torch.configs.deepseek_67b, repro_torch.configs.kimi_k2_1t_a32b\n"
        "import repro_torch.obs, repro_torch.obs.telemetry, repro_torch.obs.export\n"
        "import repro_torch.obs.prom, repro_torch.service, repro_torch.service.store\n"
        "import repro_torch.service.queue\n"
        "import repro_torch.optim, repro_torch.optim.adamw, repro_torch.optim.adafactor\n"
        "import repro_torch.optim.base, repro_torch.optim.clip, repro_torch.optim.compress\n"
        "import repro_torch.optim.schedule, repro_torch.checkpoint, repro_torch.checkpoint.ckpt\n"
        "import repro_torch.train, repro_torch.train.loop, repro_torch.launch.train\n"
        "import repro_torch.kernels.registry, repro_torch.kernels.tuning\n"
        "import repro_torch.obs.device, repro_torch.obs.profile\n"
        "import repro_torch.launch.roofline, repro_torch.launch.accounting\n"
        "from repro_torch.obs import profile_registry, trace_capture, MetricsServer\n"
        "from repro_torch.kernels import registry, tuning\n"
        "assert len(registry.registered()) == 16\n"
        "import repro_torch.models.sharding, repro_torch.launch.mesh\n"
        "from repro_torch.configs.registry import rules_for\n"
        "from repro_torch.models.spec import param_placements, distribute_params\n"
        "from repro_torch.models.moe import _ep_body, _ep_decode_body, EP_STATS\n"
        "from repro_torch.optim import compressed_psum\n"
        "from repro_torch.launch.steps import shard_batch, train_state_placements\n"
        "from repro_torch.checkpoint.ckpt import place_tree\n"
        "from repro_torch.core.fastchar import _sharded_partials\n"
        "from repro_torch.core.engine import SHARD_AXES, shard_plan\n"
        "from repro_torch.apps.fastapp import _on_shards\n"
        "from repro_torch.core.fastmoo import CompiledNSGA2\n"
        "assert CompiledNSGA2._sharded_sweep\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_context_defaults_to_the_card():
    if torch.cuda.is_available():
        assert ExecutionContext().device.startswith("cuda")
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ExecutionContext()
        with pytest.raises(RuntimeError, match="cuda"):
            ExecutionContext(device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            as_context("torch")
        with pytest.raises(RuntimeError, match="cuda"):
            as_context(None)


def _tiny_problem(n):
    zero = miqcp.QuadExpr(0.0, np.ones(n), np.zeros((n, n)))
    return miqcp.MapProblem(zero, zero, zero, 1.0, 1.0, 0.5, 0.5, 0)


def _small_mnist():
    return APPLICATIONS["mnist"](side=8, n_train_per_class=4, n_test_per_class=2)


def _tiny_dataset():
    cfg = accurate_config(spec_for(4))[None]
    return Dataset(configs=cfg, metrics={"APP_MNIST": np.zeros(1), "PDPLUT": np.ones(1)},
                   source=np.zeros(1))


ENTRY_POINTS = {
    "build_training_dataset": lambda: build_training_dataset(spec_for(4), n_random=4),
    "characterize": lambda: characterize(spec_for(4), accurate_config(spec_for(4))[None]),
    "behav_metrics": lambda: behav_metrics(spec_for(4), accurate_config(spec_for(4))[None]),
    "nsga2": lambda: nsga2(None, n_bits=8, pop_size=4, n_gen=1,
                           objs_device_fn=lambda x: x[:, :2].float()),
    "solve_enumerate": lambda: miqcp.solve_enumerate(_tiny_problem(4)),
    "solve_tabu": lambda: miqcp.solve_tabu(_tiny_problem(20)),
    "solve_pool": lambda: miqcp.solve_pool([_tiny_problem(20)]),
    "app.behav": lambda: _small_mnist().behav(spec_for(4), accurate_config(spec_for(4))[None]),
    "characterized_dataset_multi": lambda: characterized_dataset_multi(
        [_small_mnist()], spec_for(4), _tiny_dataset()),
    "run_dse(app=...)": lambda: dse.run_dse(spec_for(4), _tiny_dataset(), "ga",
                                            app=_small_mnist()),
    "init_params": lambda: init_params(model_spec(get_arch("granite-3-2b").reduced())),
    "serve.main": lambda: serve.main(["--arch", "granite-3-2b", "--gen", "2"]),
    "serve.main(mamba2-130m)": lambda: serve.main(["--arch", "mamba2-130m", "--gen", "2"]),
    "serve.main(kimi-k2-1t-a32b)": lambda: serve.main(["--arch", "kimi-k2-1t-a32b",
                                                       "--gen", "2"]),
    "behav_metrics_sampled": lambda: fastchar.behav_metrics_sampled(
        spec_for(12), accurate_config(spec_for(12))[None]),
    "run_dse_sweep": lambda: dse.run_dse_sweep(spec_for(4), _tiny_dataset(), "ga",
                                               app=_small_mnist()),
    "default_runner": lambda: service.default_runner(),
    "serve.main(--dse-service)": lambda: serve.main(
        ["--arch", "granite-3-2b", "--gen", "2", "--metrics-port", "0", "--dse-service"]),
    "train.main": lambda: train.main(["--arch", "granite-3-2b", "--steps", "1"]),
    "train.main(mamba2-130m)": lambda: train.main(["--arch", "mamba2-130m", "--steps", "1"]),
    "restore_tree": lambda: _restore_default(),
    "ExecutionContext(n_devices=2)": lambda: ExecutionContext(n_devices=2),
}


def _restore_default():
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        tree = {"w": torch.zeros(2)}
        save_tree(d, 0, tree)
        return restore_tree(d, 0, tree)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    """With no backend given, an entry point runs on the card or raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default path is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="cuda"):
        ENTRY_POINTS[name]()


def test_new_modules_are_covered_by_the_source_scan():
    """The scan above reads every module of the port, this slice's too."""
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    assert {"kernels/registry.py", "kernels/tuning.py", "obs/device.py", "obs/profile.py",
            "launch/roofline.py", "launch/accounting.py", "models/sharding.py",
            "launch/mesh.py"} <= names


@pytest.mark.gpu
def test_tuning_keys_the_card():
    from repro_torch.kernels import tuning

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    key = tuning.device_key()
    assert key.startswith("cuda:") and key.endswith("_sm90")


def test_context_validation_and_menus():
    ctx = ExecutionContext(device="cpu")
    assert ctx.is_torch and ctx.device == "cpu"
    assert as_context("numpy").backend == "numpy"
    assert as_context(ctx) is ctx
    with pytest.raises(ValueError):
        ExecutionContext(backend="jax", device="cpu")
    with pytest.raises(ValueError):
        ExecutionContext(device="cpu", kernel_impl="pallas")
    entry = ExecutionContext(device="cpu", kernel_impl="entry")
    assert entry.resolve_impl("fastchar", "table") == "entry"
    assert entry.resolve_impl("fastmoo", "kernel") == "kernel"
    plain = ExecutionContext(device="cpu", kernel_impl="plain")
    assert all(plain.resolve_impl(e, m[0]) == "plain" for e, m in ENGINE_MENUS.items())
    assert ExecutionContext(device="cpu").tuning == "off"
    assert ExecutionContext(device="cpu").tuned_tiles("fastchar.table", n_bits=8,
                                                      d=1024) == {"a_tile": 64}
    with pytest.raises(ValueError, match="tuning"):
        ExecutionContext(device="cpu", tuning="on")
