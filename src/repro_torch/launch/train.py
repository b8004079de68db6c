"""Training entry point: --arch <id> end to end on one device.

Counterpart of ``repro/launch/train.py``.  It trains the reduced config of the
chosen arch, or with ``--full-config`` the full one, from random weights made
from ``--seed`` on synthetic data (``data.SyntheticLM``), through
``make_train_step`` and the fault-tolerant ``train_loop`` with checkpoints in
``--ckpt-dir``.  It runs on the card unless ``--device`` says otherwise;
``--device cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --device cpu --steps 6 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --full-config --steps 8 --batch 8 --seq 2000 --accum 2 --int8-accum

It prints the reference's two lines (``arch=... params=...`` and ``done:
steps=... loss a -> b ...``).  The forward runs K7 in every attention layer
and K8 in every mamba layer (``FlashAttentionFn`` and ``SSDScanFn``: their
backward is the plain versions' autodiff).
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..configs.registry import ARCH_IDS, get_arch
from ..core.engine import ExecutionContext
from ..data.synthetic import SyntheticLM
from ..models.model import model_spec
from ..models.spec import count_params, init_params
from ..optim import Optimizer, cosine_schedule, make_optimizer
from ..train import TrainLoopConfig, train_loop
from .steps import make_train_step

__all__ = ["TrainRun", "batch_to_device", "build", "main", "parse_args"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--int8-accum", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


@dataclass
class TrainRun:
    """What :func:`main` trains: the pieces ``train_loop`` takes, built from
    the command line."""

    cfg: ModelConfig
    opt: Optimizer
    step_fn: Callable
    init_state: Callable
    batch_fn: Callable
    loop: TrainLoopConfig


def batch_to_device(batch: dict, device, dtype: torch.dtype) -> dict:
    """A ``SyntheticLM`` batch as the train step takes it: tensors on
    ``device``, tokens as int64, the stub frontends in ``dtype``."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    for k in ("enc_embeds", "img_embeds"):
        if k in out:
            out[k] = out[k].to(dtype)
    return out


def build(args: argparse.Namespace) -> TrainRun:
    """The run of ``args``: ``--arch``'s config, reduced unless ``--full-config``."""
    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    ctx = ExecutionContext(device=args.device)
    device = torch.device(ctx.device)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    spec = model_spec(cfg)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(
        args.lr, warmup_steps=max(args.steps // 20, 5), total_steps=args.steps))
    data = SyntheticLM(cfg, shape, seed=args.seed)
    dtype = torch.bfloat16

    def init_state():
        params = init_params(spec, seed=args.seed, dtype=dtype, device=device)
        return params, opt.init(params)

    def batch_fn(step):
        return batch_to_device(data.batch(step), device, dtype)

    return TrainRun(
        cfg=cfg, opt=opt,
        step_fn=make_train_step(cfg, opt, accum_steps=args.accum,
                                int8_accum=args.int8_accum, ctx=ctx),
        init_state=init_state, batch_fn=batch_fn,
        loop=TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                             ckpt_dir=args.ckpt_dir),
    )


def main(argv=None) -> dict:
    """Train; print the reference's two lines and return ``train_loop``'s
    result (final state, (step, loss) history, restarts, stragglers)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    run = build(args)
    print(f"arch={run.cfg.name} params={count_params(model_spec(run.cfg)):,} "
          f"tokens/step={args.seq * args.batch:,} optimizer={run.cfg.optimizer}")
    out = train_loop(run.step_fn, run.init_state, run.batch_fn, run.loop)
    first = out["history"][0][1] if out["history"] else float("nan")
    last = out["history"][-1][1] if out["history"] else float("nan")
    print(f"done: steps={len(out['history'])} loss {first:.4f} -> {last:.4f} "
          f"restarts={out['restarts']} stragglers={out['stragglers']}")
    return out


if __name__ == "__main__":
    main()
