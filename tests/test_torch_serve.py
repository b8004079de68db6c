"""AxO serving: the port's deployed model vs the reference, and the serve
entry point on the CPU.

At reduced granite-3-2b in f32 with the reference's weights (by name through
``convert.params_from_jax``): with the mild rank-16 operator of
``tests/test_axo_serving.py`` in every linear layer, the port's
teacher-forced logits along the reference's exact trajectory stay within
1e-3 relative norm of the reference's (``deploy_axo(impl="xla")``, XLA
chunked attention).  A relative tolerance, not bit-equality: a last-ulp
difference in an activation can move one int8 code.  The reference test's
fidelity bounds (top-1 >= 0.5, logit rel < 0.5) hold on the port too.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; the card's host has no JAX
import jax.numpy as jnp  # noqa: E402

from repro.axo import AXO_LAYERS as REF_AXO_LAYERS
from repro.axo import AxOOperator as RefAxOOperator
from repro.axo import deploy_axo as ref_deploy_axo
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.configs.registry import get_arch as ref_get_arch
from repro.core.operator_model import accurate_config as ref_accurate_config
from repro.core.operator_model import spec_for as ref_spec_for
from repro.data.synthetic import SyntheticLM as RefSyntheticLM
from repro.launch.steps import make_decode_step as ref_decode_step
from repro.launch.steps import make_prefill_step as ref_prefill_step
from repro.models.model import model_spec as ref_model_spec
from repro.models.sharding import BASE_RULES
from repro.models.spec import init_params as ref_init_params

from repro_torch.axo import AXO_LAYERS, AxOOperator, deploy_axo
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.launch import serve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.model import forward, logits_fn

BATCH, PLEN, GEN = 2, 8, 6
CPU = ExecutionContext(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mild(accurate, spec_of, cls, rank=16):
    """1-column truncation of the first CC row: ``test_axo_serving._mild_op``."""
    cfg = accurate(spec_of(8))
    cfg[0] = 0
    return cls.from_config(cfg, rank=rank)


def _ref_generate(prefill, decode, params, toks, gen):
    logits, cache = prefill(params, toks)
    nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out, lgs = [nxt], [logits[:, -1]]
    for i in range(PLEN, PLEN + gen - 1):
        logits, cache = decode(params, cache, nxt, jnp.int32(i))
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(nxt)
        lgs.append(logits[:, -1])
    return jnp.concatenate(out, 1), lgs


def _ref_replay(prefill, decode, params, toks, traj):
    logits, cache = prefill(params, toks)
    lgs = [logits[:, -1]]
    for j in range(traj.shape[1] - 1):
        logits, cache = decode(params, cache, traj[:, j:j + 1], jnp.int32(PLEN + j))
        lgs.append(logits[:, -1])
    return lgs


@pytest.fixture(scope="module")
def served():
    """Reference: exact greedy trajectory and AxO teacher-forced logits; the
    port's config, parameters, prompts and deployment from the same arrays."""
    rcfg = ref_get_arch("granite-3-2b").reduced()
    rparams = ref_init_params(ref_model_spec(rcfg), seed=0, dtype=jnp.float32)
    max_seq = PLEN + GEN
    data = RefSyntheticLM(rcfg, RefShapeConfig("serve", max_seq, BATCH, "train"), seed=0)
    rtoks = jnp.asarray(data.batch(0)["tokens"])[:, :PLEN]
    pre = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq))
    dec = jax.jit(ref_decode_step(rcfg, BASE_RULES))
    traj, exact_lgs = _ref_generate(pre, dec, rparams, rtoks, GEN)
    rdep = ref_deploy_axo(rparams, _mild(ref_accurate_config, ref_spec_for, RefAxOOperator),
                          rcfg, layers=REF_AXO_LAYERS, impl="xla")
    pre_a = jax.jit(ref_prefill_step(rcfg, BASE_RULES, max_seq=max_seq, axo=rdep))
    dec_a = jax.jit(ref_decode_step(rcfg, BASE_RULES, axo=rdep))
    axo_lgs = _ref_replay(pre_a, dec_a, rparams, rtoks, traj)

    cfg = get_arch("granite-3-2b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    dep = deploy_axo(params, _mild(accurate_config, spec_for, AxOOperator), cfg,
                     layers=AXO_LAYERS, ctx=CPU)
    return {
        "cfg": cfg, "params": params, "dep": dep, "max_seq": max_seq,
        "toks": torch.from_numpy(np.array(rtoks)).long(),
        "traj": torch.from_numpy(np.array(traj)).long(),
        "exact": [torch.from_numpy(np.array(x)) for x in exact_lgs],
        "axo": [torch.from_numpy(np.array(x)) for x in axo_lgs],
    }


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_axo_teacher_forced_logits_match_reference(served):
    s = served
    assert s["dep"].n_entries == 8
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], axo=s["dep"], ctx=CPU)
    dec = make_decode_step(s["cfg"], axo=s["dep"], ctx=CPU)
    got = serve.replay(pre, dec, s["params"], s["toks"], s["traj"])
    assert len(got) == GEN
    for step, (a, e) in enumerate(zip(got, s["axo"])):
        assert _rel(a, e) < 1e-3, step


def test_exact_generation_matches_reference(served):
    s = served
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], ctx=CPU)
    dec = make_decode_step(s["cfg"], ctx=CPU)
    traj, lgs, _ = serve.generate(pre, dec, s["params"], s["toks"], GEN)
    for a, e in zip(lgs, s["exact"]):
        torch.testing.assert_close(a, e, atol=2e-3, rtol=1e-3)
    assert torch.equal(traj, s["traj"])


def test_fully_deployed_generation_tracks_exact(served):
    """The reference test's fidelity bounds, on the port's own passes."""
    s = served
    pre = make_prefill_step(s["cfg"], max_seq=s["max_seq"], ctx=CPU)
    dec = make_decode_step(s["cfg"], ctx=CPU)
    traj, exact_lgs, _ = serve.generate(pre, dec, s["params"], s["toks"], GEN)
    pre_a = make_prefill_step(s["cfg"], max_seq=s["max_seq"], axo=s["dep"], ctx=CPU)
    dec_a = make_decode_step(s["cfg"], axo=s["dep"], ctx=CPU)
    top1, rel = serve.fidelity(serve.replay(pre_a, dec_a, s["params"], s["toks"], traj),
                               exact_lgs)
    assert top1 >= 0.5, (top1, rel)
    assert rel < 0.5, (top1, rel)


def test_head_only_deployment_changes_only_logits(served):
    s = served
    cfg, params = s["cfg"], s["params"]
    dep = deploy_axo(params, _mild(accurate_config, spec_for, AxOOperator), cfg,
                     layers=("head",), ctx=CPU)
    toks = torch.cat([s["toks"], s["traj"]], 1)
    x_ref, _, _ = forward(params, cfg, toks, mode="train")
    x_axo, _, _ = forward(params, cfg, toks, mode="train", axo=dep)
    assert torch.equal(x_ref, x_axo)
    lg_ref = logits_fn(params, cfg, x_ref)
    rel = _rel(logits_fn(params, cfg, x_axo, axo=dep), lg_ref)
    assert 0 < rel < 0.1


def test_serve_main_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", "granite-3-2b", "--batch", "2", "--prompt-len", "6",
                      "--gen", "4", "--axo-rank", "4", "--device", "cpu", "--requests", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=granite-3-2b-smoke prefill(2x6)=")
    assert lines[1].startswith("generated token ids (row 0): [")
    assert lines[2].startswith("axo rank=4 (8 projections, kernel): prefill=")
    assert "free-run match=" in lines[2] and "logit rel_err=" in lines[2]
    assert out["trajectory"].shape == (2, 4) and len(out["exact_logits"]) == 4
    assert (out["prefills"], out["decode_steps"]) == (2, 6)
    axo = out["axo"]
    assert (axo["prefills"], axo["decode_steps"]) == (3, 9)
    assert 0.0 <= axo["top1"] <= 1.0 and np.isfinite(axo["rel_err"])
    assert out["params"]["norm_f"].dtype == torch.bfloat16


def test_serve_main_serves_mamba_on_the_cpu(capsys):
    """Reduced mamba2-130m: 40 prompt tokens (3 chunks of 16, ragged); the AxO
    pass deploys the operator at the tied head only (a mamba layer has no
    entries, as in the reference's ``deploy_axo``)."""
    out = serve.main(["--arch", "mamba2-130m", "--batch", "2", "--prompt-len", "40",
                      "--gen", "4", "--axo-rank", "8", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=mamba2-130m-smoke prefill(2x40)=")
    assert lines[1].startswith("generated token ids (row 0): [")
    assert lines[2].startswith("axo rank=8 (1 projections, kernel): prefill=")
    assert "free-run match=" in lines[2] and "logit rel_err=" in lines[2]
    axo = out["axo"]
    dep = axo["deployment"]
    assert dep.n_entries == 1 and dep.head is not None
    assert dep.stages == {"0": {"0": {}}}
    assert out["trajectory"].shape == (2, 4) and len(axo["replay_logits"]) == 4
    assert 0.0 <= axo["top1"] <= 1.0 and 0.0 <= axo["free_run_match"] <= 1.0
    assert np.isfinite(axo["rel_err"]) and axo["rel_err"] > 0
    assert all(torch.isfinite(lg.float()).all() for lg in out["exact_logits"])


@pytest.mark.parametrize("flag, item", [(["--metrics-port", "0"], 12), (["--trace", "t.json"], 12),
                                        (["--dse-service"], 8), (["--dse-smoke", "2"], 8)])
def test_serve_flags_not_ported_raise(flag, item, tmp_path, monkeypatch):
    """The reference's serve flags, each as the port serves it now: ``--trace``
    (ported with ROADMAP.md queue 1 item 12) writes the Chrome trace of the
    serving spans; ``--metrics-port`` serves and stops its server, and the
    DSE service flags need it, as the reference's do (an argparse error)."""
    argv = ["--arch", "granite-3-2b", "--device", "cpu", "--gen", "2", *flag]
    if flag[0] == "--trace":
        monkeypatch.chdir(tmp_path)
        assert serve.main(argv)["trace"] == flag[1]
        with open(tmp_path / flag[1]) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
        assert {"serve.request", "serve.prefill", "serve.decode"} <= names
    elif flag[0] == "--metrics-port":
        assert serve.main(argv)["trajectory"].shape == (4, 2)
    else:
        with pytest.raises(SystemExit):
            serve.main(argv)


def test_serve_dse_smoke_on_cpu(tmp_path, monkeypatch):
    """``--dse-smoke`` posts its requests to the live endpoint, the queue
    answers them in one batched sweep on the CPU, and the fronts land in the
    library named by ``REPRO_OPERATOR_LIBRARY``."""
    monkeypatch.setenv("REPRO_OPERATOR_LIBRARY", str(tmp_path / "library"))
    out = serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--gen", "2",
                      "--metrics-port", "0", "--dse-smoke", "4"])
    answers = out["dse"]
    assert len(answers) == 4 and all(a["status"] == "done" for a in answers)
    assert sorted((a["request"]["const_sf"], a["request"]["seed"]) for a in answers) == \
        [(0.5, 0), (0.5, 1), (0.8, 0), (0.8, 1)]
    assert all(a["hv_vpf"] > 0 and a["n_evals"] == 16 * 9 for a in answers)
    assert (tmp_path / "library" / "fronts.jsonl").exists()


def test_serve_main_stops_its_server_and_queue_when_it_raises(tmp_path, monkeypatch, capsys):
    """A failure after the metrics server and the DSE queue are up leaves
    neither running: the port refuses connections and the worker has ended."""
    monkeypatch.setenv("REPRO_OPERATOR_LIBRARY", str(tmp_path / "library"))
    queues = []
    mount = serve._mount_dse_service

    def recording_mount(*args, **kw):
        queues.append(mount(*args, **kw))
        return queues[-1]

    def failing_serve(*args, **kw):
        raise RuntimeError("serving failed")

    monkeypatch.setattr(serve, "_mount_dse_service", recording_mount)
    monkeypatch.setattr(serve, "_serve", failing_serve)
    with pytest.raises(RuntimeError, match="serving failed"):
        serve.main(["--arch", "granite-3-2b", "--device", "cpu", "--gen", "2",
                    "--metrics-port", "0", "--dse-service"])
    url = next(line.split()[1] for line in capsys.readouterr().out.splitlines()
               if line.startswith("metrics: "))
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=5)
    assert len(queues) == 1 and not queues[0]._worker.is_alive()
