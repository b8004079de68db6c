"""End-to-end training on the PyTorch port: a real LM through the fault-tolerant loop.

  PYTHONPATH=src python examples/torch_train_lm.py [--arch internlm2-1.8b]
      [--steps 100] [--width 256] [--layers 4] [--device cpu] [--inject-fault]

Counterpart of ``examples/train_lm.py``: a width-scaled (same-family) config
that converges visibly in minutes, trained by the port's train step
(``launch.steps.make_train_step``: K7 and K8 in the forward on the card,
their plain versions on the CPU) through ``train.train_loop``, whose
checkpoint/restart path ``--inject-fault`` exercises (the run is killed at
60% of its steps and resumes from its last checkpoint).
``repro_torch/launch/train.py`` runs the full configs.
"""

import argparse
import tempfile
from dataclasses import replace

import torch

from repro_torch.configs.base import ShapeConfig, StageConfig
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core.engine import ExecutionContext
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import model_spec
from repro_torch.models.spec import count_params, init_params
from repro_torch.optim import cosine_schedule, make_optimizer
from repro_torch.train import TrainLoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=sorted(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary one)")
    ap.add_argument("--inject-fault", action="store_true",
                    help="kill the run at 60%% and prove the restart")
    args = ap.parse_args(argv)
    ctx = ExecutionContext(device=args.device)

    base = get_arch(args.arch).reduced()
    cfg = replace(
        base,
        d_model=args.width, head_dim=None, n_heads=max(4, args.width // 64),
        kv_heads=max(2, args.width // 128), d_ff=args.width * 4,
        stages=tuple(StageConfig(repeats=args.layers, layers=s.layers) for s in base.stages),
        attn_q_chunk=args.seq, attn_kv_chunk=args.seq,
    )
    spec = model_spec(cfg)
    print(f"{cfg.name}: {count_params(spec):,} params, {args.batch * args.seq} tokens/step "
          f"on {ctx.device}")

    shape = ShapeConfig("ex", args.seq, args.batch, "train")
    data = SyntheticLM(cfg, shape, seed=0)
    opt = make_optimizer(cfg.optimizer,
                         cosine_schedule(3e-3, warmup_steps=10, total_steps=args.steps))
    step = make_train_step(cfg, opt, ctx=ctx)

    def init_state():
        params = init_params(spec, seed=0, dtype=torch.float32, device=ctx.device)
        return params, opt.init(params)

    def batch_fn(s):
        return {k: torch.as_tensor(v, device=ctx.device) for k, v in data.batch(s).items()}

    fired = {"n": 0}

    def fault(s):
        if args.inject_fault and s == int(args.steps * 0.6) and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("injected node failure (example)")

    with tempfile.TemporaryDirectory() as tmp:
        out = train_loop(
            step, init_state, batch_fn,
            TrainLoopConfig(total_steps=args.steps, ckpt_every=max(args.steps // 5, 1),
                            ckpt_dir=args.ckpt_dir or tmp, log_every=10),
            fault_hook=fault,
        )
    hist = out["history"]
    print(f"loss: {hist[0][1]:.4f} -> {hist[-1][1]:.4f} over {len(hist)} steps "
          f"(restarts={out['restarts']})")
    assert hist[-1][1] < hist[0][1], "training should reduce loss"
    return out


if __name__ == "__main__":
    main()
