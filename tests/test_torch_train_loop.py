"""The port's fault-tolerant train loop (``repro_torch.train``).

Counterparts of every case in ``tests/test_train_loop.py`` (a toy quadratic
on numpy state), then the loop around the port's own train step: a reduced
model on the CPU that faults once after a checkpoint recovers to the
uninterrupted run's losses and state bit for bit, with its parameters
updated in place and saved asynchronously.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainLoopConfig, train_loop


def _toy_problem():
    """Tiny quadratic 'training' with a deterministic seekable batch fn."""
    target = np.arange(8, dtype=np.float64)

    def init_state():
        return np.zeros(8), np.zeros(8)  # params, momentum

    def batch_fn(step):
        rng = np.random.default_rng(step)
        return rng.standard_normal(8) * 0.01

    def step_fn(params, opt, step, batch):
        grad = 2 * (params - target) + batch
        opt = 0.9 * opt + grad
        params = params - 0.05 * opt
        loss = float(((params - target) ** 2).sum())
        return params, opt, {"loss": loss}

    return init_state, batch_fn, step_fn


def test_uninterrupted_run_converges(tmp_path):
    init_state, batch_fn, step_fn = _toy_problem()
    cfg = TrainLoopConfig(total_steps=60, ckpt_every=20,
                          ckpt_dir=str(tmp_path), async_ckpt=False)
    out = train_loop(step_fn, init_state, batch_fn, cfg)
    assert out["history"][-1][1] < out["history"][0][1]
    assert out["restarts"] == 0


def test_fault_injection_recovers_bitwise(tmp_path):
    init_state, batch_fn, step_fn = _toy_problem()
    cfg_a = TrainLoopConfig(total_steps=50, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "a"), async_ckpt=False)
    ref = train_loop(step_fn, init_state, batch_fn, cfg_a)

    # faulting run: dies once at step 23 (after the step-19 checkpoint)
    fired = {"n": 0}

    def fault(step):
        if step == 23 and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("injected node failure")

    cfg_b = TrainLoopConfig(total_steps=50, ckpt_every=10,
                            ckpt_dir=str(tmp_path / "b"), async_ckpt=False)
    out = train_loop(step_fn, init_state, batch_fn, cfg_b, fault_hook=fault)
    assert out["restarts"] == 1
    np.testing.assert_array_equal(out["params"], ref["params"])
    assert [l for _, l in out["history"]] == [l for _, l in ref["history"]]


def test_exhausted_restarts_reraise(tmp_path):
    init_state, batch_fn, step_fn = _toy_problem()

    def always_fault(step):
        raise RuntimeError("dead node")

    cfg = TrainLoopConfig(total_steps=10, ckpt_every=5, max_restarts=2,
                          ckpt_dir=str(tmp_path), async_ckpt=False)
    with pytest.raises(RuntimeError):
        train_loop(step_fn, init_state, batch_fn, cfg, fault_hook=always_fault)


def test_straggler_detection(tmp_path):
    init_state, batch_fn, step_fn = _toy_problem()
    seen = []

    def slow_step(params, opt, step, batch):
        if int(step) == 30:
            time.sleep(0.3)
        return step_fn(params, opt, step, batch)

    cfg = TrainLoopConfig(total_steps=40, ckpt_every=100, straggler_factor=3.0,
                          ckpt_dir=str(tmp_path), async_ckpt=False)
    out = train_loop(slow_step, init_state, batch_fn, cfg,
                     on_straggler=lambda s, dt, med: seen.append(s))
    assert out["stragglers"] >= 1
    assert 30 in seen


def test_restart_resumes_from_the_latest_checkpoint(tmp_path):
    """A new loop over the same directory picks up where the last one saved."""
    init_state, batch_fn, step_fn = _toy_problem()
    cfg = TrainLoopConfig(total_steps=20, ckpt_every=10, ckpt_dir=str(tmp_path),
                          async_ckpt=False)
    full = train_loop(step_fn, init_state, batch_fn, cfg)
    cfg.total_steps = 30
    more = train_loop(step_fn, init_state, batch_fn, cfg)
    assert [s for s, _ in more["history"]] == list(range(20, 30))
    assert more["history"][0][1] < full["history"][0][1]


def _model_run(tmp_path, name):
    args = train.parse_args(["--arch", "jamba-v0.1-52b", "--device", "cpu", "--steps", "7",
                             "--batch", "2", "--seq", "16", "--ckpt-every", "3",
                             "--ckpt-dir", str(tmp_path / name)])
    return train.build(args)


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync-save", "async-save"])
def test_model_fault_recovers_bitwise(tmp_path, async_ckpt):
    """jamba's reduced config (mamba, attention, MoE) in bf16 through the
    port's train step: a fault at step 5, after the step-2 and before the
    step-5 checkpoint, replays steps 3-4 to the same losses and state."""
    clean = _model_run(tmp_path, "a")
    clean.loop.async_ckpt = async_ckpt
    ref = train_loop(clean.step_fn, clean.init_state, clean.batch_fn, clean.loop)

    run = _model_run(tmp_path, "b")
    run.loop.async_ckpt = async_ckpt
    fired = []

    def fault(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")

    out = train_loop(run.step_fn, run.init_state, run.batch_fn, run.loop, fault_hook=fault)
    assert out["restarts"] == 1 and fired == [5]
    assert [l for _, l in out["history"]] == [l for _, l in ref["history"]]
    assert len(out["history"]) == 7
    for a, b in zip(tree_leaves(out["params"]), tree_leaves(ref["params"])):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(tree_leaves(out["opt_state"]), tree_leaves(ref["opt_state"])):
        assert torch.equal(a, b)
