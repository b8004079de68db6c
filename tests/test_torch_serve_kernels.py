"""Kernels K6 (AxO matmul), K7 (flash attention) and K8 (SSD scan) against
their plain versions on the card, and the serving paths through them.

Every test here needs an NVIDIA card (marked ``gpu``) and skips without one;
nothing here imports JAX, so the card's host runs them.  Tolerances: K6 to
1e-5 relative norm (the reference's ``axo_matmul`` tolerance; the GEMV route
sums IEEE f32 products in another order, the tensor-core route three-pass
TF32 products, tests/test_torch_kernel_design.py); K7 in f32 to 2e-6 of the
output's scale and in bf16 to one bf16 ulp (2^-7) of it, since both round
one f32 result (the bf16 kernel's p carried as bf16 hi + lo).  K8
computes over other chunk lengths than its plain version (32 against the
model's 128), in f32 or, on bf16's tensor-core route, with each f32 operand
as three bf16 terms (2^-24 relative), so the two differ by rounding: y in
f32 to 1e-5 of the output's scale, in bf16 to one bf16 ulp of it; the f32
final state to 1e-5 relative norm.
"""

import numpy as np
import pytest
import torch

from repro_torch.axo import AxOOperator, deploy_axo
from repro_torch.configs.registry import get_arch
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.launch.serve import demo_operator
from repro_torch.kernels import axo_matmul as k6
from repro_torch.kernels import flash_attention as k7
from repro_torch.kernels import ssd_scan as k8
from repro_torch.launch import serve
from repro_torch.models.model import _at, model_spec
from repro_torch.models.moe import moe_apply
from repro_torch.models.spec import init_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tables(rank, device):
    cfg = accurate_config(spec_for(8))
    cfg[0] = 0
    op = AxOOperator.from_config(cfg, rank=rank)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(device)
                 for t in (op.f_table, op.g_table, op.signed_vals))


def _op_tables(name, device):
    """The serve path's demo operator, or a random 36-bit config whose factor
    part dominates the product."""
    if name == "demo":
        op = demo_operator(8)
    else:
        op = AxOOperator.from_config(
            np.random.default_rng(36).integers(0, 2, 36).astype(np.uint8), rank=8)
    return tuple(torch.from_numpy(np.ascontiguousarray(t, np.float32)).to(device)
                 for t in (op.f_table, op.g_table, op.signed_vals))


def _rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.gpu
@pytest.mark.parametrize("m, k, n", [(4, 2048, 512), (4, 512, 49155), (37, 1000, 77),
                                     (512, 256, 1024), (1, 8192, 64)])
def test_k6_matches_plain_version_on_card(cuda, m, k, n):
    rng = np.random.default_rng(m + n)
    f, g, sv = _tables(8, cuda)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)).to(cuda)
    before = k6.axo_matmul.launches
    got = k6.axo_matmul(a, b, f, g, sv)
    want = k6.axo_matmul_plain(a, b, f, g, sv)
    torch.cuda.synchronize()
    assert k6.axo_matmul.launches == before + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["demo", "random36"])
@pytest.mark.parametrize("k, n", [(1000, 777), (2000, 1040)])
@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 64, 512])
def test_k6_routes_match_plain_version_on_card(cuda, op, k, n, m):
    """Both routes (GEMV up to M=16, tensor cores from M=17), a ragged N, a K
    that is no multiple of the 32-code step, rows that are not 16-byte
    aligned (K=1000, N=777) and rows that are (K=2000, N=1040)."""
    rng = np.random.default_rng(m * k + n)
    f, g, sv = _op_tables(op, cuda)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)).to(cuda)
    assert k6.plan(m, n, k, 8, 256).route == ("gemv" if m <= 16 else "mma")
    before = k6.axo_matmul.launches
    got = k6.axo_matmul(a, b, f, g, sv)
    want = k6.axo_matmul_plain(a, b, f, g, sv)
    torch.cuda.synchronize()
    assert k6.axo_matmul.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_k6_split_sum_is_deterministic_on_card(cuda, m):
    """The split-K partials are summed in split order by whichever block ends
    last: repeated launches give the same bits."""
    rng = np.random.default_rng(m)
    f, g, sv = _tables(8, cuda)
    a = torch.from_numpy(rng.integers(0, 256, (m, 4096)).astype(np.uint8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 256, (4096, 512)).astype(np.uint8)).to(cuda)
    assert k6.plan(m, 512, 4096, 8, 256).splits > 1
    first = k6.axo_matmul(a, b, f, g, sv)
    for _ in range(5):
        assert torch.equal(k6.axo_matmul(a, b, f, g, sv), first)


def _k6_inputs(m, k, n, device, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)).to(device),
            torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("m, splits", [(4, 1), (4, 3), (4, 64), (8, 7), (64, 1), (64, 5),
                                       (64, 16)])
def test_k6_any_split_count_matches_plain_version_on_card(cuda, m, splits):
    """The in-kernel split-K sum at split counts plan() would not pick, each
    split whole k-steps, the last one short."""
    k, n = 4000, 600
    f, g, sv = _tables(8, cuda)
    a, b = _k6_inputs(m, k, n, cuda, splits)
    pl = k6.plan(m, n, k, 8, 256)
    step = k6.GEMV_KSTEP if pl.route == "gemv" else k6.MMA_KSTEP
    k_split = -(-(-(-k // splits)) // step) * step
    pl = pl._replace(splits=-(-k // k_split), k_split=k_split)
    got = k6._launch(a, b, f, g, sv, pl)
    assert _rel(got, k6.axo_matmul_plain(a, b, f, g, sv)) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_k6_split_sums_on_two_streams_on_card(cuda, m):
    """Split-K launches on two streams at once keep separate tile counters:
    each result matches its plain version."""
    f, g, sv = _tables(8, cuda)
    k, n = 4096, 1024
    assert k6.plan(m, n, k, 8, 256).splits > 1
    inputs = [_k6_inputs(m, k, n, cuda, seed) for seed in (1, 2)]
    streams = [torch.cuda.Stream(cuda) for _ in inputs]
    torch.cuda.synchronize()
    outs = [[] for _ in inputs]
    for _ in range(20):
        for (a, b), st, got in zip(inputs, streams, outs):
            with torch.cuda.stream(st):
                got.append(k6.axo_matmul(a, b, f, g, sv))
    torch.cuda.synchronize()
    for (a, b), got in zip(inputs, outs):
        want = k6.axo_matmul_plain(a, b, f, g, sv)
        assert max(_rel(x, want) for x in got) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_k6_refuses_a_plan_off_its_layout_on_card(cuda, m):
    """The kernel's source owns its launch layout: a plan with another
    shared-memory size, a split of no whole k-steps or a GEMV row count it is
    not built for raises, and nothing launches."""
    f, g, sv = _tables(8, cuda)
    a, b = _k6_inputs(m, 2048, 512, cuda, 0)
    pl = k6.plan(m, 512, 2048, 8, 256)
    bad = [pl._replace(smem=pl.smem - 16), pl._replace(k_split=pl.k_split + 8)]
    if pl.route == "gemv":
        bad.append(pl._replace(rows=3))
    before = k6.axo_matmul.launches
    for wrong in bad:
        with pytest.raises(RuntimeError, match="does not fit the layout"):
            k6._launch(a, b, f, g, sv, wrong)
    assert k6.axo_matmul.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s, offset, hd", [(128, 0, 64), (77, 0, 64), (40, 9, 16), (5, 0, 32),
                                           (9, 30, 64), (100, 13, 32), (7, 0, 16),
                                           (70, 65, 64), (130, 0, 16),
                                           (128, 0, 128), (77, 0, 112), (40, 9, 128),
                                           (9, 30, 112), (70, 65, 128), (130, 0, 112),
                                           (200, 17, 128)])
def test_k7_matches_plain_version_on_card(cuda, dtype, s, offset, hd):
    rng = np.random.default_rng(s)
    skv = offset + s + 3                       # capacity past kv_len is masked
    q = torch.from_numpy(rng.standard_normal((2, 8, s, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, skv, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    before = k7.flash_attention.launches
    got = k7.flash_attention(q, k, v, q_offset=offset, kv_len=offset + s)
    want = k7.flash_attention_plain(q, k, v, q_offset=offset, kv_len=offset + s)
    torch.cuda.synchronize()
    assert k7.flash_attention.launches == before + 1
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * (1.0 + float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [32, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_reads_strided_model_layouts_on_card(cuda, dtype, hd):
    """q as the model's (B, S, H, hd) activations and k, v as its (B, Smax,
    G, hd) cache, transposed views read in place; the output keeps q's
    layout."""
    rng = np.random.default_rng(11)
    s, cap, off = 33, 80, 20
    q = torch.from_numpy(rng.standard_normal((2, s, 8, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, cap, 2, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype).transpose(1, 2) for t in (q, k, v))
    got = k7.flash_attention(q, k, v, q_offset=off, kv_len=off + s)
    want = k7.flash_attention_plain(q, k, v, q_offset=off, kv_len=off + s)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    assert float((got.float() - want.float()).abs().max()) <= tol * float(
        want.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [8, 48, 96, 256])
def test_k7_refuses_a_head_width_it_is_not_built_for_on_card(cuda, hd):
    """A width outside ``HEAD_DIMS`` raises on the card and launches
    nothing: no plain version serves it."""
    q = torch.randn((1, 4, 16, hd), device=cuda).to(torch.bfloat16)
    k = v = torch.randn((1, 2, 16, hd), device=cuda).to(torch.bfloat16)
    assert hd not in k7.HEAD_DIMS
    before = k7.flash_attention.launches
    with pytest.raises(ValueError, match="built for head_dim"):
        k7.flash_attention(q, k, v)
    assert k7.flash_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("k, n", [(7168, 2048), (2048, 7168)])
@pytest.mark.parametrize("m", [8, 16])
def test_k6_at_expert_buffers_matches_plain_version_on_card(cuda, m, k, n):
    """K6 at kimi-k2's expert shapes: a capacity buffer of M = 8 (decode) or
    16 (prefill) rows against an expert's gate/up (7168 x 2048) and down
    (2048 x 7168) codes, on the GEMV route; padding rows (all zero codes)
    included."""
    f, g, sv = _op_tables("demo", cuda)
    a, b = _k6_inputs(m, k, n, cuda, m + k)
    a[m // 2:] = 0                          # the buffer's unfilled rows
    assert k6.plan(m, n, k, 8, 256).route == "gemv"
    before = k6.axo_matmul.launches
    got = k6.axo_matmul(a, b, f, g, sv)
    want = k6.axo_matmul_plain(a, b, f, g, sv)
    torch.cuda.synchronize()
    assert k6.axo_matmul.launches == before + 1
    assert _rel(got, want) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, sq, skv, hd", [(True, 128, 128, 64), (True, 33, 80, 112),
                                                 (False, 70, 150, 128), (False, 40, 40, 16)])
def test_k7_op_equals_the_raw_launcher_on_card(cuda, causal, sq, skv, hd, dtype):
    """The wrapper reaches the card through ``torch.ops.repro_torch.
    flash_attention``: its output, the op's called directly and the raw
    launcher's are equal bit for bit, with q's layout, one launch each."""
    rng = np.random.default_rng(sq + skv + hd)
    q = torch.from_numpy(rng.standard_normal((2, sq, 8, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, skv, 2, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype).transpose(1, 2) for t in (q, k, v))
    off = skv - sq if causal else 0
    scale = 1.0 / hd ** 0.5
    before = k7.flash_attention.launches
    got = [k7.flash_attention(q, k, v, causal=causal, q_offset=off, kv_len=skv),
           torch.ops.repro_torch.flash_attention(q, k, v, causal, scale, off, skv),
           k7.flash_attention_raw(q, k, v, causal, scale, off, skv)]
    torch.cuda.synchronize()
    assert k7.flash_attention.launches == before + 3
    assert all(torch.equal(t, got[2]) and t.stride() == q.stride() for t in got)


@pytest.mark.gpu
def test_k7_refuses_misaligned_rows_on_card(cuda):
    """The bf16 kernel copies K/V rows in 16-byte pieces: a view whose rows do
    not start on 16-byte boundaries is refused, never served another way."""
    buf = torch.randn((1, 4, 10, 72), device=cuda).to(torch.bfloat16)
    q = buf[..., :64]                         # rows 144 bytes apart: aligned
    k = v = torch.randn((1, 2, 10, 64), device=cuda).to(torch.bfloat16)
    k7.flash_attention(q, k, v)
    bad = torch.randn((1, 4, 10, 65), device=cuda).to(torch.bfloat16)[..., :64]
    before = k7.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        k7.flash_attention(bad, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        k7.flash_attention(q, bad[:, :2], v)
    flat = torch.randn(1 + 2 * 10 * 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        k7.flash_attention(q, k, flat[1:].view(1, 2, 10, 64))
    assert k7.flash_attention.launches == before


@pytest.mark.gpu
def test_reduced_serving_runs_through_k6_and_k7_on_card(cuda):
    """The serve entry at reduced granite on the card: every AxO projection
    launches K6 (7 per layer and the head), every prefill layer K7."""
    k6.axo_matmul.launches = k7.flash_attention.launches = 0
    out = serve.main(["--arch", "granite-3-2b", "--batch", "2", "--prompt-len", "8",
                      "--gen", "6", "--axo-rank", "16"])
    torch.cuda.synchronize()
    layers = out["cfg"].n_layers
    axo = out["axo"]
    assert k7.flash_attention.launches == layers * (out["prefills"] + axo["prefills"])
    assert k6.axo_matmul.launches == (7 * layers + 1) * (axo["prefills"] + axo["decode_steps"])
    assert np.isfinite(axo["rel_err"])


def _moe_case(device):
    """Reduced kimi's first moe layer in f32 on ``device``, its input and the
    mild operator's deployment of the layer."""
    cfg = get_arch("kimi-k2-1t-a32b").reduced()
    params = init_params(model_spec(cfg), seed=0, dtype=torch.float32, device="cpu")
    params = _to(params, device)
    dep = deploy_axo(params, demo_operator(8), cfg)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32))
    p = _at(params["stages"]["1"]["0"]["mlp"], 0)
    ent = _at(dep.stages["1"]["0"]["mlp"], 0)
    return cfg, p, x.to(device), dep, ent


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_moe_layer_on_card_matches_its_cpu_run(cuda):
    """``moe_apply`` at reduced kimi on the card against the same layer on
    the CPU: the exact experts (batched products, atomic combine) to 1e-5
    relative norm, the aux loss to 1e-5; the AxO experts through K6, one
    launch a projection of each of the 8 experts and of the shared expert, to
    the AxO serving contract of 1e-3."""
    cfg, p_c, x_c, dep_c, ent_c = _moe_case("cpu")
    _, p_g, x_g, dep_g, ent_g = _moe_case(cuda)
    want, want_aux = moe_apply(p_c, x_c, cfg)
    got, aux = moe_apply(p_g, x_g, cfg)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), want) < 1e-5
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * float(want_aux)
    want_a, _ = moe_apply(p_c, x_c, cfg, axo=(dep_c, ent_c))
    before = k6.axo_matmul.launches
    got_a, _ = moe_apply(p_g, x_g, cfg, axo=(dep_g, ent_g))
    torch.cuda.synchronize()
    assert k6.axo_matmul.launches == before + 3 * cfg.moe.n_experts + 3
    assert _rel(got_a.cpu(), want_a) < 1e-3


@pytest.mark.gpu
def test_reduced_moe_serving_runs_through_k6_and_k7_on_card(cuda):
    """The serve entry at reduced kimi-k2 on the card: K7 in every prefill
    layer, K6 for every deployed projection, each routed expert's three
    included, a forward."""
    k6.axo_matmul.launches = k7.flash_attention.launches = 0
    out = serve.main(["--arch", "kimi-k2-1t-a32b", "--batch", "2", "--prompt-len", "8",
                      "--gen", "4", "--axo-rank", "8"])
    torch.cuda.synchronize()
    cfg, axo = out["cfg"], out["axo"]
    per_forward = 1 + 7 * cfg.stages[0].repeats + cfg.stages[1].repeats * (
        4 + 3 + 3 * cfg.moe.n_experts)
    assert k7.flash_attention.launches == cfg.n_layers * (out["prefills"] + axo["prefills"])
    assert k6.axo_matmul.launches == per_forward * (axo["prefills"] + axo["decode_steps"])
    assert np.isfinite(axo["rel_err"])


def _ssd_inputs(b, s, h, g, p, n, dtype, device, seed):
    """The reference kernel test's draws; x, B and C as strided views into one
    (B, S, H*P + 2*G*N) buffer, as the model passes them."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * g * n)).astype(np.float32))
    buf = buf.to(device, dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(b, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)).to(device)
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32)).to(device)
    return x, dt, a, bm, cm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, s, h, g, p, n, chunk", [
    (8, 2000, 24, 1, 64, 128, 128),    # mamba2-130m's prefill in chip_smoke.py
    (2, 40, 16, 1, 8, 16, 16),         # the reduced config, ragged
    (2, 256, 4, 1, 16, 32, 64),        # the reference kernel test's shapes
    (1, 128, 8, 2, 8, 16, 32),
    (1, 64, 4, 4, 8, 8, 64),
    (3, 77, 8, 2, 32, 64, 128),        # G > 1, one ragged chunk
])
def test_k8_matches_plain_version_on_card(cuda, dtype, b, s, h, g, p, n, chunk):
    x, dt, a, bm, cm = _ssd_inputs(b, s, h, g, p, n, dtype, cuda, s + h)
    init = None
    if g > 1:   # a nonzero entering state on the grouped shapes
        init = torch.randn((b, h, p, n), generator=torch.Generator(cuda).manual_seed(s),
                           device=cuda)
    before = k8.ssd_scan.launches
    y, st = k8.ssd_scan(x, dt, a, bm, cm, chunk=chunk, init_state=init)
    y_p, st_p = k8.ssd_scan_plain(x, dt, a, bm, cm, chunk=chunk, init_state=init)
    torch.cuda.synchronize()
    assert k8.ssd_scan.launches == before + 1
    assert y.dtype == dtype and st.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = float((y.float() - y_p.float()).abs().max())
    assert err <= tol * float(y_p.float().abs().max()), err
    assert _rel(st, st_p) < 1e-5


def _k8_close(y, st, y_p, st_p):
    tol = 1e-5 if y.dtype == torch.float32 else 2.0 ** -7
    err = float((y.float() - y_p.float()).abs().max())
    assert err <= tol * float(y_p.float().abs().max()), err
    assert _rel(st, st_p) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n", k8.STATE_DIMS)
@pytest.mark.parametrize("p", k8.HEAD_DIMS)
def test_k8_tensor_core_route_at_every_width_on_card(cuda, p, n):
    """The bf16 tensor-core route at every (P, N) it is built for, ragged S,
    an entering state, two groups."""
    x, dt, a, bm, cm = _ssd_inputs(2, 75, 4, 2, p, n, torch.bfloat16, cuda, p + n)
    init = torch.randn((2, 4, p, n), generator=torch.Generator(cuda).manual_seed(n),
                       device=cuda)
    assert k8.route(x) == "mma"
    mma_before, grids_before = k8.ssd_scan.route_launches["mma"], k8.grids()
    y, st = k8.ssd_scan(x, dt, a, bm, cm, init_state=init)
    torch.cuda.synchronize()
    assert k8.ssd_scan.route_launches["mma"] == mma_before + 1
    assert k8.grids() == grids_before + 2         # the scores, then the scan
    _k8_close(y, st, *k8.ssd_scan_plain(x, dt, a, bm, cm, init_state=init))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k8_first_design_and_unaligned_rows_on_card(cuda, dtype):
    """f32 takes the first design, whatever its rows' alignment; bf16 rows
    that are not 16-byte aligned are refused.  ssd_scan_scalar runs the first
    design on aligned bf16 too and counts its own launches."""
    b, s, h, g, p, n = 2, 70, 4, 1, 16, 32
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal((b, s, h * p + 2 * g * n + 1)).astype(
        np.float32)).to(cuda, dtype)
    x = buf[..., 1:1 + h * p].reshape(b, s, h, p)         # rows one element off alignment
    bm = buf[..., 1 + h * p:1 + h * p + g * n].reshape(b, s, g, n)
    cm = buf[..., 1 + h * p + g * n:].reshape(b, s, g, n)
    _, dt, a, _, _ = _ssd_inputs(b, s, h, g, p, n, dtype, cuda, 3)
    before, scalar_before = k8.ssd_scan.launches, k8.ssd_scan_scalar.launches
    if dtype == torch.bfloat16:
        for fn in (k8.ssd_scan, k8.ssd_scan_scalar):
            with pytest.raises(ValueError, match="16-byte boundary"):
                fn(x, dt, a, bm, cm)
        x, dt, a, bm, cm = _ssd_inputs(b, s, h, g, p, n, dtype, cuda, 3)
    assert k8.route(x) == ("scalar" if dtype == torch.float32 else "mma")
    want = k8.ssd_scan_plain(x, dt, a, bm, cm)
    _k8_close(*k8.ssd_scan(x, dt, a, bm, cm), *want)
    grids_before = k8.grids()
    _k8_close(*k8.ssd_scan_scalar(x, dt, a, bm, cm), *want)
    assert k8.grids() == grids_before + 1         # the first design: one grid
    torch.cuda.synchronize()
    assert k8.ssd_scan.launches == before + 1
    assert k8.ssd_scan_scalar.launches == scalar_before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_k8_op_equals_the_raw_launcher_on_card(cuda, dtype, with_state):
    """The wrapper reaches the card through ``torch.ops.repro_torch.ssd_scan``:
    its (y, state), the op's called directly and the raw launcher's are equal
    bit for bit, one launch each."""
    x, dt, a, bm, cm = _ssd_inputs(2, 75, 8, 2, 16, 32, dtype, cuda, 5)
    init = torch.randn((2, 8, 16, 32), generator=torch.Generator(cuda).manual_seed(5),
                       device=cuda) if with_state else None
    before = k8.ssd_scan.launches
    got = [k8.ssd_scan(x, dt, a, bm, cm, chunk=32, init_state=init),
           torch.ops.repro_torch.ssd_scan(x, dt, a, bm, cm, init, 32),
           k8.ssd_scan_raw(x, dt, a, bm, cm, init)]
    torch.cuda.synchronize()
    assert k8.ssd_scan.launches == before + 3
    assert all(torch.equal(y, got[2][0]) and torch.equal(st, got[2][1]) for y, st in got)


@pytest.mark.gpu
def test_k8_rejects_what_it_is_not_built_for(cuda):
    x, dt, a, bm, cm = _ssd_inputs(1, 8, 2, 1, 8, 16, torch.float32, cuda, 0)
    with pytest.raises(TypeError, match="float32 dt"):
        k8.ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError, match="contiguous last axis"):
        k8.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a, bm, cm)
    x12, dt12, a12, bm12, cm12 = _ssd_inputs(1, 8, 2, 1, 12, 16, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="built for"):
        k8.ssd_scan(x12, dt12, a12, bm12, cm12)


@pytest.mark.gpu
def test_reduced_mamba_serving_runs_through_k8_on_card(cuda):
    """The serve entry at reduced mamba2-130m on the card: every prefill layer
    launches K8; the AxO head launches K6 once per AxO forward."""
    k6.axo_matmul.launches = k7.flash_attention.launches = k8.ssd_scan.launches = 0
    out = serve.main(["--arch", "mamba2-130m", "--batch", "2", "--prompt-len", "40",
                      "--gen", "6", "--axo-rank", "8"])
    torch.cuda.synchronize()
    layers = out["cfg"].n_layers
    axo = out["axo"]
    assert axo["deployment"].n_entries == 1
    assert k8.ssd_scan.launches == layers * (out["prefills"] + axo["prefills"])
    assert k6.axo_matmul.launches == axo["prefills"] + axo["decode_steps"]
    assert k7.flash_attention.launches == 0
    assert np.isfinite(axo["rel_err"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq, skv, h, g, hd", [(128, 1500, 16, 16, 64), (1500, 1500, 16, 16, 64),
                                               (128, 1600, 64, 8, 128), (77, 1537, 8, 2, 112)])
def test_k7_non_causal_at_long_unequal_lengths_on_card(cuda, dtype, sq, skv, h, g, hd):
    """K7 with ``causal=False``: whisper's cross-attention (Sq 128 x Skv 1,500,
    hd 64) and encoder (1,500 x 1,500), the VLM's cross-attention (128 x
    1,600, hd 128, H 64 / G 8) and a ragged case; Skv is no multiple of the
    64-key tile, so the last tile is zero-filled past kv_len and masked.
    bf16 to one ulp of the output's scale; f32 to 2e-6 of the scale of the
    terms summed, the largest softmax-weighted sum of |v| (over 1,500 random
    keys the output itself cancels to a fifth of that, and f32 rounding of
    the sum scales with the terms)."""
    rng = np.random.default_rng(skv + sq)
    q = torch.from_numpy(rng.standard_normal((2, h, sq, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, g, skv, hd)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(cuda, dtype) for t in (q, k, v))
    before = k7.flash_attention.launches
    got = k7.flash_attention(q, k, v, causal=False, kv_len=skv)
    want = k7.flash_attention_plain(q, k, v, causal=False, kv_len=skv)
    torch.cuda.synchronize()
    assert k7.flash_attention.launches == before + 1
    if dtype == torch.float32:
        scale = k7.flash_attention_plain(q, k, v.abs(), causal=False, kv_len=skv).abs().max()
        tol = 2e-6 * float(scale)
    else:
        tol = 2.0 ** -7 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("k, n", [(4096, 14336), (14336, 4096), (7168, 2048), (2048, 7168)])
@pytest.mark.parametrize("m", [24, 80])
def test_k6_at_prefill_expert_buffers_matches_plain_version_on_card(cuda, m, k, n):
    """K6 at the prefill expert buffers of deepseek-v3 (M = 24) and jamba (M =
    80) against their experts' gate/up and down codes, on the tensor-core
    route; the buffer's unfilled rows (all-zero codes) included."""
    f, g, sv = _op_tables("demo", cuda)
    a, b = _k6_inputs(m, k, n, cuda, m + k)
    a[2 * m // 3:] = 0
    assert k6.plan(m, n, k, 8, 256).route == "mma"
    before = k6.axo_matmul.launches
    got = k6.axo_matmul(a, b, f, g, sv)
    want = k6.axo_matmul_plain(a, b, f, g, sv)
    torch.cuda.synchronize()
    assert k6.axo_matmul.launches == before + 1
    assert _rel(got, want) < 1e-5


def _launches_a_forward(cfg, mode: str) -> dict:
    """K6, K7 and K8 launches of one forward of ``cfg`` with every AxO layer
    group deployed: the cross K/V projections (and the encoder) run only at
    the prefill, attention kernels only there."""
    mlp = 3 if cfg.act == "swiglu" else 2
    pre = mode == "prefill"
    k6n = {"attn": 4, "attn_nc": 4, "mla": 4, "mamba": 0, "xattn": 4 if pre else 2,
           "attn_x": 8 if pre else 6}
    k7n = {"attn": 1, "attn_nc": 1, "xattn": 1, "attn_x": 2, "mla": 0, "mamba": 0}
    out = {"K6": 1, "K7": 0, "K8": 0}
    layers = [(st.repeats, mx, ff) for st in cfg.stages for mx, ff in st.layers]
    if cfg.encoder is not None and pre:
        layers.append((cfg.encoder.n_layers, "attn_nc", "dense"))
    for rep, mixer, ff in layers:
        ffn = {"dense": mlp, "none": 0}.get(ff) if ff != "moe" else (
            3 * cfg.moe.n_experts + (mlp if cfg.moe.n_shared else 0))
        out["K6"] += rep * (k6n[mixer] + ffn)
        out["K7"] += rep * k7n[mixer] * pre
        out["K8"] += rep * (mixer == "mamba") * pre
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "deepseek-v3-671b", "whisper-medium",
                                  "llama-3.2-vision-90b"])
def test_reduced_families_serve_through_the_kernels_on_card(cuda, arch):
    """The serve entry at the reduced hybrid, MLA, encoder-decoder and VLM
    configs on the card: K7 in every attention layer of a prefill (whisper's
    encoder and cross-attention non-causal; none for MLA), K8 in every mamba
    layer, K6 for every deployed projection of a forward."""
    for fn in (k6.axo_matmul, k7.flash_attention, k8.ssd_scan):
        fn.launches = 0
    out = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "8", "--gen", "4",
                      "--axo-rank", "8"])
    torch.cuda.synchronize()
    cfg, axo = out["cfg"], out["axo"]
    pre, dec = _launches_a_forward(cfg, "prefill"), _launches_a_forward(cfg, "decode")
    assert dec["K7"] == dec["K8"] == 0
    prefills = out["prefills"] + axo["prefills"]
    assert k7.flash_attention.launches == pre["K7"] * prefills
    assert k8.ssd_scan.launches == pre["K8"] * prefills
    assert k6.axo_matmul.launches == (pre["K6"] * axo["prefills"]
                                      + dec["K6"] * axo["decode_steps"])
    assert (arch == "deepseek-v3-671b") == (pre["K7"] == 0)
    assert np.isfinite(axo["rel_err"])
