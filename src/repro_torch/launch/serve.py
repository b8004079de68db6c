"""Serving entry point: prefill a batch of prompts, decode greedily with a KV cache
-- optionally with AxO-approximate arithmetic deployed in every linear layer
(the paper's operators in the serving path, via ``deploy_axo``).

Counterpart of ``repro/launch/serve.py``.  It serves randomly initialized
weights made from ``--seed``, as the reference does, on one device: the card
by default, ``--device cpu`` for the host.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --batch 4 --prompt-len 24 --gen 16 [--axo-rank 8] [--full-config]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --batch 8 --prompt-len 2000 --gen 32 [--axo-rank 8] [--full-config]

The model decides which kernels a request runs.  granite-3-2b's prefill
attention runs kernel K7; mamba2-130m's prefill scan runs kernel K8 in every
layer and its decode is the plain O(1) recurrence.  Every AxO projection runs
kernel K6: all seven of a granite layer's and the tied head, and for
mamba2-130m the head alone.  On the CPU the kernels' plain versions run;
``--axo-impl plain`` puts the AxO projections on K6's plain version.  The reference's telemetry flags (``--metrics-port``,
``--trace``) wait for ROADMAP.md queue 1 item 12 and its DSE service flags
(``--dse-service``, ``--dse-smoke``) for item 8; each raises when given.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..axo import AXO_LAYERS, AxOOperator, deploy_axo
from ..configs.base import ShapeConfig
from ..configs.registry import ARCH_IDS, get_arch
from ..core.engine import ENGINE_MENUS, ExecutionContext
from ..core.operator_model import accurate_config, spec_for
from ..data.synthetic import SyntheticLM
from ..models.model import model_spec
from ..models.spec import init_params
from .steps import make_decode_step, make_prefill_step

__all__ = ["demo_operator", "generate", "replay", "fidelity", "main"]

# flags of the reference's serve entry point that the port does not serve yet
_NOT_PORTED = {"metrics_port": 12, "trace": 12, "dse_service": 8, "dse_smoke": 8}


def demo_operator(rank: int) -> AxOOperator:
    """The classic 1-column truncated multiplier (drop the lowest
    partial-product column of every row) -- a mild, deterministic Pareto
    design; no DSE run needed for a serving demo."""
    spec8 = spec_for(8)
    op_cfg = accurate_config(spec8)
    for r in range(spec8.rows):
        op_cfg[r * spec8.cols_removable] = 0
    return AxOOperator.from_config(op_cfg, rank=rank)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(prefill, decode, params, toks, gen: int):
    """Greedy generation: (tokens (B, gen), last-step logits per step, (t_pre, t_dec) s).

    The two times are host clocks around work that ends in a device sync.
    """
    device = toks.device
    plen = toks.shape[1]
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    nxt = logits[:, -1].argmax(-1)[:, None]
    out, lgs = [nxt], [logits[:, -1]]
    _sync(device)
    t_pre = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(plen, plen + gen - 1):
        logits, cache = decode(params, cache, nxt, i)
        nxt = logits[:, -1].argmax(-1)[:, None]
        out.append(nxt)
        lgs.append(logits[:, -1])
    _sync(device)
    return torch.cat(out, 1), lgs, (t_pre, time.perf_counter() - t0)


def replay(prefill, decode, params, toks, trajectory) -> list:
    """Teacher-forced logits along ``trajectory`` (B, gen): one per step."""
    plen = toks.shape[1]
    logits, cache = prefill(params, toks)
    lgs = [logits[:, -1]]
    for j in range(trajectory.shape[1] - 1):
        logits, cache = decode(params, cache, trajectory[:, j:j + 1], plen + j)
        lgs.append(logits[:, -1])
    return lgs


def fidelity(got: list, want: list) -> tuple[float, float]:
    """(top-1 agreement, relative logit error), each the mean over steps."""
    top1 = sum(float((a.argmax(-1) == e.argmax(-1)).float().mean())
               for a, e in zip(got, want)) / len(want)
    rel = sum(float(torch.linalg.vector_norm((a - e).float())
                    / torch.linalg.vector_norm(e.float()).clamp(min=1e-9))
              for a, e in zip(got, want)) / len(want)
    return top1, rel


def main(argv=None) -> dict:
    """Serve; print the reference's lines and return what was measured.

    The returned dict holds the numbers printed, the config, parameters,
    prompts, the exact trajectory and logits, and under ``"axo"`` the
    deployment and its teacher-forced logits, so a caller can replay either
    pass on another route.
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--axo-rank", type=int, default=0,
                    help=">0: deploy a rank-R AxO operator into every linear "
                         "layer and report divergence on the decoded trajectory")
    ap.add_argument("--axo-layers", nargs="+", default=list(AXO_LAYERS),
                    choices=list(AXO_LAYERS))
    ap.add_argument("--axo-impl", default=None, choices=list(ENGINE_MENUS["axo_matmul"]),
                    help="route of the AxO projections: kernel K6 (the default) "
                         "or its plain version")
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--requests", type=int, default=1,
                    help="number of exact serving requests to run (the last is timed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="not ported yet (ROADMAP.md queue 1 item 12)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="not ported yet (ROADMAP.md queue 1 item 12)")
    ap.add_argument("--dse-service", action="store_true",
                    help="not ported yet (ROADMAP.md queue 1 item 8)")
    ap.add_argument("--dse-smoke", type=int, default=0, metavar="N",
                    help="not ported yet (ROADMAP.md queue 1 item 8)")
    args = ap.parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) != ap.get_default(flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported yet "
                                      f"(ROADMAP.md queue 1 item {item})")

    ctx = ExecutionContext(device=args.device)
    device = torch.device(ctx.device)
    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    max_seq = args.prompt_len + args.gen

    params = init_params(model_spec(cfg), seed=args.seed, device=device)
    data = SyntheticLM(cfg, ShapeConfig("serve", max_seq, args.batch, "train"), seed=args.seed)
    toks = torch.from_numpy(data.batch(0)["tokens"][:, : args.prompt_len]).long().to(device)

    prefill = make_prefill_step(cfg, max_seq=max_seq, ctx=ctx)
    decode = make_decode_step(cfg, ctx=ctx)
    for _ in range(max(0, args.requests - 1)):
        generate(prefill, decode, params, toks, args.gen)   # warm repeats
    out, exact_lgs, (t_prefill, t_decode) = generate(prefill, decode, params, toks, args.gen)
    print(f"arch={cfg.name} prefill({args.batch}x{args.prompt_len})="
          f"{t_prefill*1e3:.1f}ms decode({args.gen - 1} steps)={t_decode*1e3:.1f}ms")
    print("generated token ids (row 0):", out[0].tolist())
    result = {
        "cfg": cfg, "params": params, "tokens": toks, "max_seq": max_seq,
        "trajectory": out, "exact_logits": exact_lgs,
        "exact_prefill_ms": t_prefill * 1e3, "exact_decode_ms": t_decode * 1e3,
        "prefills": max(1, args.requests), "decode_steps": max(1, args.requests) * (args.gen - 1),
    }

    if args.axo_rank > 0:
        # deploy the operator into every requested linear layer, rebuild the
        # steps around the deployment, and serve the SAME prompts -- the
        # divergence is scored on the decoded trajectory, not random inputs
        op = demo_operator(args.axo_rank)
        axo_ctx = ExecutionContext(device=ctx.device, kernel_impl=args.axo_impl)
        dep = deploy_axo(params, op, cfg, layers=tuple(args.axo_layers), ctx=axo_ctx)
        pre_a = make_prefill_step(cfg, max_seq=max_seq, axo=dep, ctx=ctx)
        dec_a = make_decode_step(cfg, axo=dep, ctx=ctx)
        out_a, _, _ = generate(pre_a, dec_a, params, toks, args.gen)  # warm + free-run tokens
        _, _, (tp, td) = generate(pre_a, dec_a, params, toks, args.gen)

        # teacher-forced comparison along the exact trajectory
        rep = replay(pre_a, dec_a, params, toks, out)
        top1, rel = fidelity(rep, exact_lgs)
        match = float((out_a == out).float().mean())
        print(f"axo rank={args.axo_rank} ({dep.n_entries} projections, {dep.impl}): "
              f"prefill={tp*1e3:.1f}ms decode={td*1e3:.1f}ms  "
              f"free-run match={match:.2%} teacher-forced top1={top1:.2%} "
              f"logit rel_err={rel:.4f}")
        result["axo"] = {
            "deployment": dep, "replay_logits": rep, "prefill_ms": tp * 1e3,
            "decode_ms": td * 1e3, "free_run_match": match, "top1": top1, "rel_err": rel,
            "prefills": 3, "decode_steps": 3 * (args.gen - 1),
        }
    return result


if __name__ == "__main__":
    main()
