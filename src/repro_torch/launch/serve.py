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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b \\
      --device cpu --batch 2 --prompt-len 8 --gen 4 --axo-rank 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \\
      --device cpu --batch 2 --prompt-len 8 --gen 4 --axo-rank 8

``--arch`` takes every arch of the reference: the dense granite-3-2b,
internlm2-1.8b, starcoder2-3b and deepseek-67b, the MoE kimi-k2-1t-a32b and
deepseek-v3-671b (MLA), the SSM mamba2-130m, the hybrid jamba-v0.1-52b, the
encoder-decoder whisper-medium and the VLM llama-3.2-vision-90b.  The model
decides which kernels a request runs.  Prefill self-attention runs kernel
K7 in every attention layer, at head width 64 (granite, whisper), 128
(internlm2, starcoder2, deepseek-67b, jamba, the VLM) or 112 (kimi-k2);
whisper's encoder layers and its and the VLM's cross-attention take K7
non-causal (Sq 128 against 1,500 frames or 1,600 image tokens at the
prefill below).  deepseek-v3's MLA attention (q/k width 576, v width 512)
runs the port's plain attention, as the reference runs its XLA paths there.
A mamba layer's prefill scan runs kernel K8 (mamba2-130m, jamba); its decode
is the plain O(1) recurrence.  Every AxO projection runs kernel K6: a
layer's attention projections (MLA's wq_a, wq_b, wkv_a and wo; the cross
K/V only at the prefill, from the encoder or image states), its MLP's, in a
MoE layer the shared expert's and three for each routed expert at M = the
expert's capacity buffer, and the head; a mamba mixer has none.  The MoE
router stays exact.  whisper's frame embeddings and the VLM's patch
embeddings are the reference's stub frontends, drawn by ``SyntheticLM``
from ``--seed``.  On the CPU the kernels' plain versions run; ``--axo-impl
plain`` puts the AxO projections on K6's plain version.  Full width
(``--full-config``) needs the card, and the large archs fit it only cut in
depth, as ``chip_smoke.py`` cuts them: deepseek-67b (~134 GB of bf16
weights), kimi-k2 (~2 TB), deepseek-v3 (~1.3 TB), jamba (~103 GB) and the
VLM (~175 GB).

``--metrics-port`` serves ``GET /metrics`` (Prometheus text of the process's
telemetry: the serving latency histograms, the DSE service's counters) and
``GET /healthz`` (the card's liveness and the deployment).  ``--dse-service``
mounts the persistent DSE service on that server: ``POST /dse`` queues a
(n_bits, op, signed, app, const_sf, seed, method) job, ``GET /dse?id=<job>``
polls it, ``GET /dse/library`` reports the operator library
(``$REPRO_OPERATOR_LIBRARY``, default ``experiments/library``); the queue
coalesces compatible jobs into one ``run_dse_sweep`` on the serving device.
``--dse-smoke N`` posts N small requests to the live endpoint after serving
and waits for their fronts.  ``--trace PATH`` writes the Chrome trace of
the serving spans (each request, its prefill and its decode) at the run's
end, loadable in Perfetto.
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request

import torch

from ..axo import AXO_LAYERS, AxOOperator, deploy_axo
from ..configs.base import ShapeConfig
from ..configs.registry import ARCH_IDS, get_arch
from ..core.engine import ENGINE_MENUS, ExecutionContext
from ..core.operator_model import accurate_config, spec_for
from ..data.synthetic import SyntheticLM
from ..models.model import model_spec
from ..models.spec import init_params
from ..obs import telemetry as obs
from .steps import make_decode_step, make_prefill_step

__all__ = ["demo_operator", "generate", "replay", "fidelity", "main", "parse_args",
           "serve_config"]


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


def generate(prefill, decode, params, toks, gen: int, tel=None, label: str = "exact",
             frontend=None):
    """Greedy generation: (tokens (B, gen), last-step logits per step, (t_pre, t_dec) s).

    ``frontend`` is the stub modality input the prefill takes (whisper's
    frames, the VLM's image tokens), ``None`` for a text-only arch.

    The two times are host clocks around work that ends in a device sync.
    With a telemetry sink ``tel`` the call is one request span: its prefill
    time and each decode step's host time land in the ``serve.prefill_ms``
    and ``serve.decode_step_ms`` histograms, its decode rate in the
    ``serve.tokens_per_s`` gauge, as the reference records them.
    """
    tel = obs.NULL if tel is None else tel
    device = toks.device
    plen = toks.shape[1]
    with tel.span("serve.request", label=label, batch=toks.shape[0], prompt_len=plen,
                  gen=gen):
        _sync(device)
        t0 = time.perf_counter()
        with tel.span("serve.prefill"):
            logits, cache = prefill(params, toks, frontend)
            nxt = logits[:, -1].argmax(-1)[:, None]
            out, lgs = [nxt], [logits[:, -1]]
            _sync(device)
        t_pre = time.perf_counter() - t0
        tel.observe("serve.prefill_ms", t_pre * 1e3)
        t0 = time.perf_counter()
        with tel.span("serve.decode", steps=gen - 1):
            for i in range(plen, plen + gen - 1):
                ts = time.perf_counter()
                logits, cache = decode(params, cache, nxt, i)
                nxt = logits[:, -1].argmax(-1)[:, None]
                tel.observe("serve.decode_step_ms", (time.perf_counter() - ts) * 1e3)
                out.append(nxt)
                lgs.append(logits[:, -1])
            _sync(device)
        t_dec = time.perf_counter() - t0
        if t_dec > 0:
            tel.gauge("serve.tokens_per_s", toks.shape[0] * (gen - 1) / t_dec)
        tel.count("serve.requests")
    return torch.cat(out, 1), lgs, (t_pre, t_dec)


def replay(prefill, decode, params, toks, trajectory, frontend=None) -> list:
    """Teacher-forced logits along ``trajectory`` (B, gen): one per step."""
    plen = toks.shape[1]
    logits, cache = prefill(params, toks, frontend)
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
    pass on another route; ``"telemetry"`` is the run's sink (its spans, its
    latency histograms, its kernels' pad waste).
    """
    args = parse_args(argv)
    cfg = get_arch(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    return serve_config(cfg, args)


def parse_args(argv=None) -> argparse.Namespace:
    """:func:`main`'s command line, checked."""
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
                    help="serve GET /metrics (Prometheus text exposition of "
                         "the process's telemetry) and GET /healthz (the card's "
                         "liveness + deployment status) on this port; 0 picks "
                         "an ephemeral port")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome-trace JSON of the serving spans "
                         "(load at ui.perfetto.dev)")
    ap.add_argument("--dse-service", action="store_true",
                    help="mount the persistent DSE service on the metrics "
                         "server: POST /dse submits a (n_bits, op, signed, "
                         "app, const_sf, seed, method) job into the batched "
                         "queue, GET /dse?id=<job> polls its result, GET "
                         "/dse/library reports the operator-library status; "
                         "requires --metrics-port")
    ap.add_argument("--dse-smoke", type=int, default=0, metavar="N",
                    help="after serving, POST N small DSE requests to the "
                         "live endpoint and wait for their fronts (endpoint "
                         "self-test; implies --dse-service)")
    ap.add_argument("--dse-pop", type=int, default=16,
                    help="service GA population per request lane")
    ap.add_argument("--dse-gens", type=int, default=8,
                    help="service GA generations per request lane")
    args = ap.parse_args(argv)
    if args.dse_smoke:
        args.dse_service = True
    if args.dse_service and args.metrics_port is None:
        ap.error("--dse-service requires --metrics-port")
    return args


def serve_config(cfg, args: argparse.Namespace) -> dict:
    """:func:`main`'s run with ``cfg`` served in place of ``--arch``'s
    registry entry (``chip_smoke.py`` passes configs cut in depth); returns
    what :func:`main` returns."""
    ctx = ExecutionContext(device=args.device)
    # one sink for the serving run: the latency histograms and gauges, the
    # kernels' once-a-shape records (current for the run), counters chained to
    # the process aggregate that /metrics renders
    tel = obs.Telemetry("serve", parent=obs.GLOBAL)
    metrics = dse_queue = None
    try:
        if args.metrics_port is not None:
            from ..obs.prom import MetricsServer

            metrics = MetricsServer(tel=obs.GLOBAL, port=args.metrics_port).start()
            print(f"metrics: {metrics.url}/metrics  health: {metrics.url}/healthz")
        dse_queue = _mount_dse_service(metrics, args, ctx) if args.dse_service else None
        with obs.use(tel):
            return _serve(cfg, args, ctx, tel, metrics, dse_queue)
    finally:
        # the server's thread and socket and the queue's worker end with the
        # run, whether it returned or raised
        if dse_queue is not None:
            dse_queue.close()
        if metrics is not None:
            metrics.stop()


def _serve(cfg, args, ctx, tel, metrics, dse_queue) -> dict:
    """The serving run of :func:`main` once its metrics server and DSE
    service are up: exact requests, then the AxO deployment and the DSE
    endpoint's self-test where asked."""
    device = torch.device(ctx.device)
    max_seq = args.prompt_len + args.gen

    params = init_params(model_spec(cfg), seed=args.seed, device=device)
    data = SyntheticLM(cfg, ShapeConfig("serve", max_seq, args.batch, "train"), seed=args.seed)
    batch = data.batch(0)
    toks = torch.from_numpy(batch["tokens"][:, : args.prompt_len]).long().to(device)
    frontend = None   # the stub modality input, in the parameters' dtype
    for key in ("enc_embeds", "img_embeds"):
        if key in batch:
            frontend = torch.from_numpy(batch[key]).to(device, params["norm_f"].dtype)

    prefill = make_prefill_step(cfg, max_seq=max_seq, ctx=ctx)
    decode = make_decode_step(cfg, ctx=ctx)
    for _ in range(max(0, args.requests - 1)):
        generate(prefill, decode, params, toks, args.gen, tel, frontend=frontend)  # warm
    out, exact_lgs, (t_prefill, t_decode) = generate(prefill, decode, params, toks, args.gen,
                                                     tel, frontend=frontend)
    print(f"arch={cfg.name} prefill({args.batch}x{args.prompt_len})="
          f"{t_prefill*1e3:.1f}ms decode({args.gen - 1} steps)={t_decode*1e3:.1f}ms")
    print("generated token ids (row 0):", out[0].tolist())
    result = {
        "cfg": cfg, "params": params, "tokens": toks, "frontend": frontend,
        "max_seq": max_seq,
        "trajectory": out, "exact_logits": exact_lgs,
        "exact_prefill_ms": t_prefill * 1e3, "exact_decode_ms": t_decode * 1e3,
        "prefills": max(1, args.requests), "decode_steps": max(1, args.requests) * (args.gen - 1),
        "telemetry": tel,
    }
    if metrics is not None:
        metrics.set_deployment({"mode": "exact", "arch": cfg.name})

    if args.axo_rank > 0:
        # deploy the operator into every requested linear layer, rebuild the
        # steps around the deployment, and serve the SAME prompts -- the
        # divergence is scored on the decoded trajectory, not random inputs
        op = demo_operator(args.axo_rank)
        axo_ctx = ExecutionContext(device=ctx.device, kernel_impl=args.axo_impl)
        dep = deploy_axo(params, op, cfg, layers=tuple(args.axo_layers), ctx=axo_ctx)
        pre_a = make_prefill_step(cfg, max_seq=max_seq, axo=dep, ctx=ctx)
        dec_a = make_decode_step(cfg, axo=dep, ctx=ctx)
        out_a, _, _ = generate(pre_a, dec_a, params, toks, args.gen, tel,
                               "axo", frontend)  # warm + free-run tokens
        _, _, (tp, td) = generate(pre_a, dec_a, params, toks, args.gen, tel, "axo", frontend)

        # teacher-forced comparison along the exact trajectory
        rep = replay(pre_a, dec_a, params, toks, out, frontend)
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
        tel.gauge("serve.axo_top1", top1)
        tel.gauge("serve.axo_free_run_match", match)
        tel.gauge("serve.axo_logit_rel_err", rel)
        if metrics is not None:
            metrics.set_deployment({
                "mode": "axo", "arch": cfg.name, "rank": args.axo_rank,
                "impl": dep.impl, "layers": list(args.axo_layers),
                "projections": dep.n_entries, "top1": top1, "free_run_match": match,
            })

    if args.dse_smoke:
        result["dse"] = _dse_smoke(metrics, dse_queue, args.dse_smoke)
    if args.trace is not None:
        tel.to_chrome_trace(args.trace)
        print(f"chrome trace: {args.trace} ({len(tel.spans)} spans; load at ui.perfetto.dev)")
        for h in ("serve.prefill_ms", "serve.decode_step_ms"):
            s = tel.histogram_summary(h)
            if s["count"]:
                print(f"{h}: n={s['count']} p50={s['p50']:.1f} p90={s['p90']:.1f} "
                      f"max={s['max']:.1f}")
        result["trace"] = args.trace
    return result


def _mount_dse_service(metrics, args, ctx):
    """The DSE job queue, its operator library and their three routes on the
    metrics server; the queue's sweeps run on ``ctx``'s device."""
    from ..core.dse import DSESettings
    from ..service import DSEJobQueue, DSERequest, OperatorStore, default_runner
    from ..service.store import store_status

    store = OperatorStore()
    queue = DSEJobQueue(default_runner(
        settings=DSESettings(pop_size=args.dse_pop, n_gen=args.dse_gens, context=ctx),
        store=store,
    ))

    def post_dse(payload: dict) -> dict:
        job_id = queue.submit(DSERequest.from_dict(payload))
        return {"job_id": job_id, "queued": queue.depth()}

    def get_dse(params: dict) -> dict:
        res = queue.result(params["id"])
        return res if res is not None else {"status": "pending"}

    metrics.add_route("POST", "/dse", post_dse)
    metrics.add_route("GET", "/dse", get_dse)
    metrics.add_route("GET", "/dse/library", lambda params: store_status(store))
    print(f"dse service: POST {metrics.url}/dse (library: {store.root})")
    return queue


def _dse_smoke(metrics, queue, n: int) -> list[dict]:
    """Endpoint self-test: post ``n`` small 4-bit requests through the live
    HTTP surface (not the queue object), wait for every front and return the
    answers; raises where one is not done."""
    t0 = time.perf_counter()
    jobs = []
    for i in range(n):
        body = json.dumps({"n_bits": 4, "const_sf": 0.5 + 0.3 * (i % 2),
                           "seed": i // 2}).encode()
        req = urllib.request.Request(f"{metrics.url}/dse", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as resp:
            jobs.append(json.loads(resp.read())["job_id"])
    if not queue.join(timeout=600):
        raise RuntimeError("dse smoke: jobs did not finish in 600s")
    answers = []
    for jid in jobs:
        with urllib.request.urlopen(f"{metrics.url}/dse?id={jid}") as resp:
            res = json.loads(resp.read())
        if res["status"] != "done":
            raise RuntimeError(f"dse smoke: {jid} -> {res}")
        print(f"dse {jid}: const_sf={res['request']['const_sf']} "
              f"seed={res['request']['seed']} hv={res['hv_vpf']:.4g} "
              f"front={len(res['front'])}")
        answers.append(res)
    print(f"dse smoke: {n} requests -> {obs.GLOBAL.counter('service.batches')} batched "
          f"dispatch(es) in {time.perf_counter() - t0:.1f}s")
    return answers


if __name__ == "__main__":
    main()
