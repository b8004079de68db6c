"""The four PyTorch example drivers run end to end on the CPU at their smallest flags.

Each ``examples/torch_*.py`` is loaded from its file and its ``main([...])``
called with ``--device cpu`` (every engine on its plain version) at flags
cut for a test: the quickstart's DSE loop and K6 deployment, the operator
DSE (operator level and an application target), AxO serving of a reduced
LM with a deployed operator, and the training loop with an injected fault
and its restart.  What each returns is checked for its sense (finite
hypervolumes, agreement in [0, 1], a loss that falls), not for a value.
"""

import importlib.util
import math
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_cpu():
    out = _load("torch_quickstart").main(["--device", "cpu", "--n-random", "60", "--pop", "8",
                                         "--gens", "3"])
    assert out["hv_ga"] > 0 and out["hv_mapga"] > 0
    assert math.isfinite(out["rel"])


@pytest.mark.parametrize("app", [None, "mnist"])
def test_operator_dse_runs_on_the_cpu(app):
    argv = ["--device", "cpu", "--n-random", "60", "--pop", "8", "--gens", "2"]
    out = _load("torch_operator_dse").main(argv + ([] if app is None else ["--app", app]))
    assert set(out) == {"ga", "map", "map+ga", "library"}
    assert all(math.isfinite(v) and v >= 0 for v in out.values())


def test_axo_serving_runs_on_the_cpu():
    out = _load("torch_axo_serving").main([
        "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4", "--ranks", "4",
        "--dse-random", "40", "--dse-gens", "2"])
    assert set(out) == {4}
    assert all(0.0 <= v <= 1.0 for v in (out[4]["match"], out[4]["top1"]))
    assert math.isfinite(out[4]["rel"])


def test_train_lm_runs_and_restarts_on_the_cpu(tmp_path):
    out = _load("torch_train_lm").main([
        "--device", "cpu", "--steps", "6", "--width", "64", "--layers", "1", "--batch", "2",
        "--seq", "16", "--inject-fault", "--ckpt-dir", str(tmp_path / "ckpt")])
    hist = out["history"]
    assert out["restarts"] == 1
    assert [s for s, _ in hist] == list(range(6))
    assert hist[-1][1] < hist[0][1]
