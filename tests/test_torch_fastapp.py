"""Port table-matmul routes and the K4/K5 plain versions vs the reference.

The reference's Pallas wrappers do not run on the installed JAX, so the port
is held against the reference's other routes for the same function --
``fastapp.table_matmul_jax(impl="xla"|"entry"|"gemm")``, the convolutions'
gather and GEMM routes and ``mismatch_counts`` -- and against the numpy
oracle ``apps.base.table_matmul``.  Every output is an exact integer, so
every comparison is bit-for-bit.  Inputs are made from a seed with numpy and
handed to both packages.
"""

import numpy as np
import pytest
import torch

from repro.apps.base import table_conv1d as ref_table_conv1d
from repro.apps.base import table_conv2d as ref_table_conv2d
from repro.apps.base import table_matmul as ref_table_matmul
from repro.core.miqcp import _all_configs
from repro.core.operator_model import product_tables as ref_product_tables
from repro.core.operator_model import spec_for as ref_spec_for

from repro_torch.apps import fastapp
from repro_torch.core.engine import ExecutionContext
from repro_torch.core.operator_model import accurate_config, spec_for
from repro_torch.kernels import app_kernels

CPU = ExecutionContext(device="cpu")
ROUTES = fastapp.MATMUL_IMPLS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU tensors here are small: intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_fastapp():
    """The reference's device engine (imports JAX, which the card's host lacks)."""
    pytest.importorskip("jax")
    from repro.apps import fastapp as ref

    return ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _configs(n_bits, n, seed):
    """``n`` random configs, then the all-zeros and the accurate config."""
    spec = spec_for(n_bits)
    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 2, (n, spec.n_luts)).astype(np.uint8)
    return np.concatenate(
        [cfgs, np.zeros((1, spec.n_luts), np.uint8), accurate_config(spec)[None]]
    )


def _codes(n_bits, shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << n_bits, shape).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32))


def _oracle(tables, a, b):
    return np.stack([ref_table_matmul(t, a, b) for t in tables])


@pytest.fixture(scope="module")
def cfgs8():
    cfgs = _configs(8, 14, 0)
    return cfgs, ref_product_tables(ref_spec_for(8), cfgs)


# the mnist head, the ffn GEMM1 and a ragged K
SHAPES = {"mnist": (250, 256, 10), "ffn1": (96, 64, 128), "ragged_k": (23, 100, 7)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k4_k5_plain_and_routes_match_reference(ref_fastapp, cfgs8, shape):
    cfgs, tables = cfgs8
    m, k, n = SHAPES[shape]
    a, b = _codes(8, (m, k), 1), _codes(8, (k, n), 2)
    rbatch = ref_fastapp.table_batch(ref_spec_for(8), cfgs)
    want = np.asarray(ref_fastapp.table_matmul_jax(rbatch, a, b, impl="xla"))
    for impl in ("entry", "gemm"):
        np.testing.assert_array_equal(
            np.asarray(ref_fastapp.table_matmul_jax(rbatch, a, b, impl=impl)), want
        )
    np.testing.assert_array_equal(want, _oracle(tables, a, b))

    tflat = _t(tables.reshape(len(cfgs), -1))
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=CPU)
    np.testing.assert_array_equal(app_kernels.table_gemv_plain(tflat, _t(a), _t(b)), want)
    np.testing.assert_array_equal(
        app_kernels.entry_gemv_plain(batch.masks, _t(a), _t(b), 8), want
    )
    np.testing.assert_array_equal(app_kernels.table_gemv(tflat, _t(a), _t(b)), want)
    np.testing.assert_array_equal(app_kernels.entry_gemv(batch.masks, _t(a), _t(b), 8), want)
    for impl in ROUTES:
        got = fastapp.table_matmul_torch(batch, a, b, impl=impl)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)


def test_zero_code_padding_is_inert(cfgs8):
    """Every table maps codes (0, 0) to 0: K padded with zero codes adds nothing."""
    cfgs, tables = cfgs8
    a, b = _codes(8, (9, 37), 3), _codes(8, (37, 4), 4)
    ap = np.concatenate([a, np.zeros((9, 11), np.int64)], axis=1)
    bp = np.concatenate([b, np.zeros((11, 4), np.int64)], axis=0)
    assert (tables[:, 0, 0] == 0).all()
    tflat = _t(tables.reshape(len(cfgs), -1))
    masks = fastapp.table_batch(spec_for(8), cfgs, ctx=CPU).masks
    np.testing.assert_array_equal(app_kernels.table_gemv_plain(tflat, _t(ap), _t(bp)),
                                  app_kernels.table_gemv_plain(tflat, _t(a), _t(b)))
    np.testing.assert_array_equal(app_kernels.entry_gemv_plain(masks, _t(ap), _t(bp), 8),
                                  app_kernels.entry_gemv_plain(masks, _t(a), _t(b), 8))


@pytest.fixture(scope="module")
def all4x4():
    spec = ref_spec_for(4)
    cfgs = _all_configs(spec.n_luts)
    a, b = _codes(4, (5, 24), 20), _codes(4, (24, 3), 21)
    return cfgs, a, b, _oracle(ref_product_tables(spec, cfgs), a, b)


@pytest.mark.parametrize("impl", ROUTES)
def test_exhaustive_4x4_all_1024_configs(all4x4, impl):
    cfgs, a, b, want = all4x4
    batch = fastapp.table_batch(spec_for(4), cfgs, ctx=CPU)
    np.testing.assert_array_equal(
        fastapp.table_matmul_torch(batch, a, b, impl=impl).numpy(), want
    )


def test_exhaustive_4x4_kernel_plain_versions(all4x4):
    cfgs, a, b, want = all4x4
    batch = fastapp.table_batch(spec_for(4), cfgs, ctx=CPU)
    np.testing.assert_array_equal(
        app_kernels.entry_gemv_plain(batch.masks, _t(a), _t(b), 4).numpy(), want
    )
    tflat = batch.tables.reshape(len(cfgs), -1)
    np.testing.assert_array_equal(
        app_kernels.table_gemv_plain(tflat, _t(a), _t(b), d_chunk=100).numpy(), want
    )


@pytest.mark.parametrize("impl", [None, "entry_gather", "plain"])
def test_per_config_codes_match_reference(ref_fastapp, cfgs8, impl):
    cfgs, tables = cfgs8
    a3 = _codes(8, (len(cfgs), 9, 33), 6)
    b = _codes(8, (33, 5), 7)
    rbatch = ref_fastapp.table_batch(ref_spec_for(8), cfgs)
    want = np.asarray(ref_fastapp.table_matmul_jax(rbatch, a3, b, impl="xla"))
    np.testing.assert_array_equal(
        np.asarray(ref_fastapp.table_matmul_jax(rbatch, a3, b, impl="entry")), want
    )
    np.testing.assert_array_equal(
        want, np.stack([ref_table_matmul(t, x, b) for t, x in zip(tables, a3)])
    )
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=CPU)
    np.testing.assert_array_equal(
        fastapp.table_matmul_torch(batch, a3, b, impl=impl).numpy(), want
    )


@pytest.mark.parametrize("d_chunk", [1, 3, 100])
def test_plain_versions_take_per_config_codes(ref_fastapp, cfgs8, d_chunk):
    """K4's and K5's plain versions take (D, M, K) codes as well, in any chunking."""
    cfgs, _ = cfgs8
    a3 = _codes(8, (len(cfgs), 7, 40), 23)
    b = _codes(8, (40, 6), 24)
    rbatch = ref_fastapp.table_batch(ref_spec_for(8), cfgs)
    want = np.asarray(ref_fastapp.table_matmul_jax(rbatch, a3, b, impl="xla"))
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=CPU)
    tflat = batch.tables.reshape(len(cfgs), -1)
    np.testing.assert_array_equal(
        app_kernels.table_gemv_plain(tflat, _t(a3), _t(b), d_chunk).numpy(), want
    )
    np.testing.assert_array_equal(
        app_kernels.planes_gemv_plain(batch.entry_small, _t(a3), _t(b), d_chunk).numpy(), want
    )


@pytest.mark.parametrize("impl", ROUTES)
def test_conv1d_conv2d_match_reference(ref_fastapp, cfgs8, impl):
    cfgs, tables = cfgs8
    x, h = _codes(8, 200, 8), _codes(8, 15, 9)
    img, kern = _codes(8, (24, 24), 10), _codes(8, (5, 5), 11)
    rbatch = ref_fastapp.table_batch(ref_spec_for(8), cfgs)
    want1 = np.asarray(ref_fastapp.table_conv1d_jax(rbatch, x, h, impl="xla"))
    want2 = np.asarray(ref_fastapp.table_conv2d_jax(rbatch, img, kern, impl="xla"))
    np.testing.assert_array_equal(want1[3], ref_table_conv1d(tables[3], x, h))
    np.testing.assert_array_equal(want2[3], ref_table_conv2d(tables[3], img, kern))
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=CPU)
    np.testing.assert_array_equal(
        fastapp.table_conv1d_torch(batch, x, h, impl=impl).numpy(), want1
    )
    np.testing.assert_array_equal(
        fastapp.table_conv2d_torch(batch, img, kern, impl=impl).numpy(), want2
    )



@pytest.mark.parametrize("name, m, k", [("ecg", 2034, 15), ("gauss", 8464, 25)])
def test_table_route_convolutions_go_through_k4(monkeypatch, name, m, k):
    """Under the default ``table`` route the apps' convolutions are K4's N=1
    table matmul (on the CPU its wrapper runs the plain version), and their
    BEHAV still equals the numpy oracle (ecg exactly, gauss to 1e-6)."""
    from repro_torch.apps import APPLICATIONS

    calls = []
    real = app_kernels.table_gemv

    def spy(tables_flat, a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(tables_flat, a, b)

    monkeypatch.setattr(app_kernels, "table_gemv", spy)
    app = APPLICATIONS[name]()
    cfgs = _configs(8, 6, 30)
    got = app.behav(spec_for(8), cfgs, backend=CPU)
    assert calls == [((m, k), (k, 1))]
    want = app.behav(spec_for(8), cfgs, backend="numpy")
    if name == "ecg":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)

def test_mismatch_counts_break_ties_on_the_first_maximum(ref_fastapp):
    """Integer logits tie; the prediction is the first maximum, as numpy's."""
    spec = spec_for(4)
    rng = np.random.default_rng(12)
    labels = rng.integers(0, 5, 40)
    a, w = _codes(4, (40, 6), 13), _codes(4, (6, 5), 14)
    w[:, 3] = w[:, 1]            # columns 1 and 3 give equal logits everywhere
    tables = np.stack([
        np.zeros((16, 16), np.int32),                     # every logit 0: all tie
        np.ones((16, 16), np.int32),                      # every logit K: all tie
        ref_product_tables(ref_spec_for(4), accurate_config(spec)[None])[0],
    ])
    want = np.array([(np.argmax(ref_table_matmul(t, a, w), axis=1) != labels).sum()
                     for t in tables])
    ref = np.asarray(ref_fastapp.mismatch_counts(tables, a, w, labels, impl="xla"))
    np.testing.assert_array_equal(ref, want)
    for impl in ("table", "plain"):
        got = fastapp.mismatch_counts(torch.from_numpy(tables), a, w, labels, impl=impl)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want[0] == (labels != 0).sum() and want[1] == (labels != 0).sum()


def test_table_batch_pieces_match_reference():
    spec = spec_for(8)
    cfgs = _configs(8, 6, 15)
    batch = fastapp.table_batch(spec, cfgs, ctx=CPU)
    assert len(batch) == 8 and batch.n_codes == 256 and batch.device.type == "cpu"
    assert batch._tables is None and batch._small is None
    assert torch.equal(batch.small, batch.entry_small)
    np.testing.assert_array_equal(batch.tables.numpy(),
                                  ref_product_tables(ref_spec_for(8), cfgs))
    np.testing.assert_array_equal(fastapp.product_tables_torch(spec, cfgs, CPU).numpy(),
                                  batch.tables.numpy())


def test_entry_routes_never_build_tables():
    batch = fastapp.table_batch(spec_for(8), _configs(8, 4, 16), ctx=CPU)
    a, b = _codes(8, (6, 32), 17), _codes(8, (32, 4), 18)
    for impl in ("entry", "entry_gather"):
        fastapp.table_matmul_torch(batch, a, b, impl=impl)
    assert batch._tables is None and batch._small is None


def test_route_resolution():
    spec = spec_for(8)
    cfgs = _configs(8, 3, 19)
    batch = fastapp.table_batch(spec, cfgs, ctx=CPU)
    raw = fastapp.TableBatch(masks=None, n_bits=8, _tables=batch.tables)
    a, b = _codes(8, (4, 8), 20), _codes(8, (8, 3), 21)
    want = fastapp.table_matmul_torch(batch, a, b, impl="plain")
    # an explicit route that cannot run the batch raises
    for impl in ("entry", "entry_gather", "gemm"):
        with pytest.raises(ValueError):
            fastapp.table_matmul_torch(raw, a, b, impl=impl)
    big = _codes(8, (2, 40000), 22)
    with pytest.raises(ValueError, match="f32"):
        fastapp.table_matmul_torch(batch, big, big[:1].T, impl="gemm")
    a3 = np.broadcast_to(a, (len(cfgs),) + a.shape)
    for impl in ("table", "entry", "gemm"):
        with pytest.raises(ValueError, match="per-config"):
            fastapp.table_matmul_torch(batch, a3, b, impl=impl)
    with pytest.raises(ValueError, match="unknown"):
        fastapp.table_matmul_torch(batch, a, b, impl="pallas")
    # a context preference gives way where the reference's does
    for pref in ("entry", "gemm", "entry_gather"):
        ctx = ExecutionContext(device="cpu", kernel_impl=pref)
        raw_pref = fastapp.TableBatch(masks=None, n_bits=8, ctx=ctx, _tables=batch.tables)
        assert fastapp._resolve_impl(None, raw_pref, 8) == "plain"
        assert torch.equal(fastapp.table_matmul_torch(raw_pref, a, b), want)
    assert fastapp._resolve_impl(None, batch, 8) == "table"
    gemm = fastapp.table_batch(spec, cfgs, ctx=ExecutionContext(device="cpu",
                                                                kernel_impl="gemm"))
    assert fastapp._resolve_impl(None, gemm, 40000) == "plain"
    entry = fastapp.table_batch(spec, cfgs, ctx=ExecutionContext(device="cpu",
                                                                 kernel_impl="entry"))
    assert fastapp._resolve_impl(None, entry, 8, per_config=True) == "entry_gather"
    assert fastapp._resolve_impl(None, batch, 8, per_config=True) == "plain"
    assert fastapp._resolve_impl("plain", batch, 8) == "plain"


def test_kernel_wrappers_check_their_inputs():
    tflat = torch.zeros((2, 256 * 256), dtype=torch.int32)
    masks = torch.zeros((2, 4), dtype=torch.int32)
    a = torch.zeros((3, 5), dtype=torch.int32)
    b = torch.zeros((5, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        app_kernels.table_gemv(tflat.long(), a, b)
    with pytest.raises(ValueError, match="disagree"):
        app_kernels.table_gemv(tflat, a, b[:4])
    with pytest.raises(ValueError, match="4\\^n_bits"):
        app_kernels.table_gemv(tflat[:, :1000].contiguous(), a, b)
    wide = torch.zeros((1, app_kernels.MAX_K + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="overflow"):
        app_kernels.table_gemv(tflat, wide, wide.T.contiguous())
    with pytest.raises(ValueError, match="shape"):
        app_kernels.entry_gemv(masks[:, :3].contiguous(), a, b, 8)
    with pytest.raises(ValueError):
        app_kernels.entry_gemv(masks, a, b, 12)
    with pytest.raises(ValueError, match="contiguous"):
        app_kernels.table_gemv(tflat, a, torch.zeros((2, 5), dtype=torch.int32).T)
    assert app_kernels.table_gemv(tflat, a[:, :0], b[:0]).abs().sum() == 0
    mnist = app_kernels.plan(250, 256, 10, 8)
    assert mnist.route == "staged" and mnist.smem <= app_kernels.MAX_SMEM
    gather = app_kernels.plan(250, 256, 10, 8, "gather")
    assert (gather.m_tile, gather.k_tile) == (32, 256)
    m_tile, k_tile = app_kernels._tiles(96, 64, 128, 4 * 4 * 256)
    assert (m_tile * (k_tile + 1) + k_tile * 128 + 4096) * 4 <= app_kernels.SMEM_BUDGET


# the five shapes chip_smoke.py runs K4 at: the mnist head, the ffn GEMM1, a
# ragged K, and the ecg and gauss convolutions
CARD_SHAPES = {"mnist": (250, 256, 10), "ffn": (96, 64, 128), "ragged": (250, 100, 10),
               "ecg": (2034, 15, 1), "gauss": (8464, 25, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_k4_routes_match_plain_k5_and_gemm_on_card(cuda, shape):
    """Both of K4's routes, named, equal the plain version, K5 and the gemm
    route; each call counts one launch, on its route."""
    m, k, n = CARD_SHAPES[shape]
    cfgs = _configs(8, 126, 31)
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=ExecutionContext())
    a, b = _t(_codes(8, (m, k), 32)).to(cuda), _t(_codes(8, (k, n), 33)).to(cuda)
    tflat = batch.tables.reshape(len(cfgs), -1)
    want = app_kernels.table_gemv_plain(tflat, a, b)
    k5 = app_kernels.entry_gemv(batch.masks, a, b, 8)
    gemm = fastapp.table_matmul_torch(batch, a, b, impl="gemm")
    for route in ("staged", "gather"):
        before = (app_kernels.table_gemv.launches, dict(app_kernels.table_gemv.route_launches))
        got = app_kernels.table_gemv(tflat, a, b, route=route)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got, k5) and torch.equal(got, gemm), route
        assert app_kernels.table_gemv.launches == before[0] + 1
        assert app_kernels.table_gemv.route_launches[route] == before[1][route] + 1
    plan = app_kernels.plan(m, k, n, 8)
    assert plan.route == ("gather" if shape == "ecg" else "staged")


@pytest.mark.gpu
def test_k4_staged_launcher_refuses_what_its_layout_cannot_hold_on_card(cuda):
    """The staged launcher computes its own layout: it refuses a scratch
    buffer smaller than the layout needs, a shape over the block's shared
    memory and 1-bit codes, and launches nothing."""
    lib = app_kernels._lib()
    tflat = torch.zeros((2, 1 << 16), dtype=torch.int32, device=cuda)
    out = torch.empty(1 << 22, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(m, k, n, n_bits, short=0):
        a = torch.zeros((m, k), dtype=torch.int32, device=cuda)
        b = torch.zeros((k, n), dtype=torch.int32, device=cuda)
        need = lib.table_gemv_staged_scratch(m, k, n, max(n_bits, 2))
        scratch = torch.empty(need, dtype=torch.uint8, device=cuda)
        return lib.table_gemv_staged_launch(
            tflat.data_ptr(), a.data_ptr(), b.data_ptr(), scratch.data_ptr(),
            need - short, out.data_ptr(), 2, m, k, n, n_bits, stream)

    assert launch(250, 256, 10, 8) == 0
    assert launch(250, 256, 10, 8, short=1) != 0
    assert launch(4096, 1024, 10, 8) != 0
    assert launch(40000, 16, 1, 8) != 0
    assert launch(64, 16, 4, 1) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k4_k5_match_plain_versions_on_card(cuda, shape):
    m, k, n = SHAPES[shape]
    cfgs = _configs(8, 126, 23)
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=ExecutionContext())
    a, b = _t(_codes(8, (m, k), 24)).to(cuda), _t(_codes(8, (k, n), 25)).to(cuda)
    tflat = batch.tables.reshape(len(cfgs), -1)
    before = (app_kernels.table_gemv.launches, app_kernels.entry_gemv.launches)
    k4 = app_kernels.table_gemv(tflat, a, b)
    k5 = app_kernels.entry_gemv(batch.masks, a, b, 8)
    p4 = app_kernels.table_gemv_plain(tflat, a, b)
    p5 = app_kernels.entry_gemv_plain(batch.masks, a, b, 8)
    torch.cuda.synchronize()
    assert torch.equal(k4, p4) and torch.equal(k5, p5) and torch.equal(k4, k5)
    assert app_kernels.table_gemv.launches == before[0] + 1
    assert app_kernels.entry_gemv.launches == before[1] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_cfgs", [128, 20, 37])
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_k5_designs_match_plain_and_k4_on_card(cuda, shape, n_cfgs):
    """K5's redesign (nibble planes, a config's slabs split over blocks where
    D is below the SM count) and its first design equal the plain version
    and K4 at the five app shapes, at D=128, at D=20 (split) and at a ragged
    D=37; each call counts one launch on its own wrapper."""
    m, k, n = CARD_SHAPES[shape]
    cfgs = _configs(8, n_cfgs - 2, 41)
    batch = fastapp.table_batch(spec_for(8), cfgs, ctx=ExecutionContext())
    a, b = _t(_codes(8, (m, k), 42)).to(cuda), _t(_codes(8, (k, n), 43)).to(cuda)
    want = app_kernels.entry_gemv_plain(batch.masks, a, b, 8)
    before = (app_kernels.entry_gemv.launches, app_kernels.entry_gemv_first.launches)
    got = app_kernels.entry_gemv(batch.masks, a, b, 8)
    first = app_kernels.entry_gemv_first(batch.masks, a, b, 8)
    k4 = app_kernels.table_gemv(batch.tables.reshape(len(cfgs), -1), a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(first, want) and torch.equal(k4, want)
    assert (app_kernels.entry_gemv.launches,
            app_kernels.entry_gemv_first.launches) == (before[0] + 1, before[1] + 1)
    splits = app_kernels.entry_splits(len(cfgs), m, k, n, 8)
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    slabs = -(-m // 32)
    assert 1 <= splits <= slabs
    assert (splits == 1) == (len(cfgs) * 2 > n_sms or slabs == 1)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [2, 4, 6])
def test_k5_designs_at_narrow_widths_on_card(cuda, n_bits):
    """4 and 6 bits (an odd row count: the last plane has 4 entries) and 2,
    ragged M and K, codes out of range."""
    cfgs = _configs(n_bits, 35, 44)
    batch = fastapp.table_batch(spec_for(n_bits), cfgs, ctx=ExecutionContext())
    g = np.random.default_rng(45)
    nb = 1 << n_bits
    a = _t(g.integers(-nb, 2 * nb, (77, 23))).to(cuda)
    b = _t(g.integers(0, nb, (23, 6))).to(cuda)
    want = app_kernels.entry_gemv_plain(batch.masks, a, b, n_bits)
    got = app_kernels.entry_gemv(batch.masks, a, b, n_bits)
    first = app_kernels.entry_gemv_first(batch.masks, a, b, n_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(first, want)


@pytest.mark.gpu
def test_k5_launcher_refuses_what_its_layout_cannot_hold_on_card(cuda):
    """K5's launcher computes its own layout, splitting a config's slabs
    further where the sums do not fit: it refuses a layout over 227 KiB even
    at one slab a block, a short scratch buffer and odd widths, and launches
    nothing; the wrapper raises on such a shape before any launch."""
    lib = app_kernels._lib()
    masks = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    out = torch.empty(1 << 22, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def launch(m, k, n, n_bits, short=0):
        a = torch.zeros((m, k), dtype=torch.int32, device=cuda)
        b = torch.zeros((k, n), dtype=torch.int32, device=cuda)
        need = lib.entry_gemv_scratch(m, k, n)
        scratch = torch.empty(need, dtype=torch.uint8, device=cuda)
        return lib.entry_gemv_launch(masks.data_ptr(), a.data_ptr(), b.data_ptr(),
                                     scratch.data_ptr(), need - short, out.data_ptr(), 2, m,
                                     k, n, n_bits, stream)

    assert launch(250, 256, 10, 8) == 0
    assert launch(250, 256, 10, 8, short=1) != 0
    assert launch(64, 4096, 10, 8) != 0       # two 1-slab A tiles of 4,112-byte rows: 263 KB
    assert launch(40000, 16, 1, 8) == 0       # the sums fit once the slabs are split
    assert launch(64, 16, 4, 5) != 0
    assert app_kernels.entry_splits(2, 64, 4096, 10, 8) == 0
    assert app_kernels.entry_splits(2, 40000, 16, 1, 8) > 1
    torch.cuda.synchronize()
    big = torch.zeros((64, 4096), dtype=torch.int32, device=cuda)
    before = app_kernels.entry_gemv.launches
    with pytest.raises(ValueError, match="K5 cannot take"):
        app_kernels.entry_gemv(masks, big, torch.zeros((4096, 10), dtype=torch.int32,
                                                       device=cuda), 8)
    assert app_kernels.entry_gemv.launches == before


# ---------------------------------------------------------------------------
# 12-bit operands: K5's plain version and app BEHAV on the entry route
# ---------------------------------------------------------------------------
#
# The reference admits 12-bit codes on its table-free routes only; its
# ``table_matmul_jax(impl="entry")`` sums int32 modulo 2^32, and so do the
# port's K5 plain version and kernel.  Every comparison is exact.

SHAPES12 = {"mnist-like": (40, 64, 10), "ffn1": (24, 32, 16), "conv": (120, 15, 1),
            "wraps": (6, 700, 3)}


def _wrapping_codes(shape, seed):
    """12-bit codes of magnitude near 2^11, so that K=700 products overflow int32."""
    rng = np.random.default_rng(seed)
    mag = rng.integers(1800, 2048, shape)
    return np.where(rng.random(shape) < 0.5, mag, 4096 - mag).astype(np.int64)


@pytest.mark.parametrize("shape", sorted(SHAPES12))
def test_k5_plain_12bit_matches_reference_entry(ref_fastapp, shape):
    m, k, n = SHAPES12[shape]
    spec, rspec = spec_for(12), ref_spec_for(12)
    cfgs = _configs(12, 5, 61)
    if shape == "wraps":
        a, b = _wrapping_codes((m, k), 62), _wrapping_codes((k, n), 63)
    else:
        a, b = _codes(12, (m, k), 62), _codes(12, (k, n), 63)
    rctx = _ref_ctx(kernel_impl="entry")
    want = np.asarray(ref_fastapp.table_matmul_jax(
        ref_fastapp.table_batch(rspec, cfgs, ctx=rctx), a, b, impl="entry"))
    batch = fastapp.table_batch(spec, cfgs, ctx=CPU)
    got = app_kernels.entry_gemv(batch.masks, _t(a), _t(b), 12)     # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), want)
    routed = fastapp.table_matmul_torch(batch, a, b, impl="entry")
    np.testing.assert_array_equal(routed.numpy(), want)
    exact = app_kernels.entry_gemv_plain(batch.masks, _t(a), _t(b), 12, acc_dtype=torch.int64)
    wrapped = (exact.abs() >= 2**31).any()
    assert bool(wrapped) == (shape == "wraps")
    np.testing.assert_array_equal(exact.numpy().astype(np.int32), want)   # modulo 2^32


def _ref_ctx(**kw):
    from repro.core.engine import ExecutionContext as RefContext

    return RefContext(backend="jax", **kw)


SMALL12 = {
    "ecg": dict(n_samples=512),
    "mnist": dict(side=8, n_train_per_class=12, n_test_per_class=6),
    "gauss": dict(side=32),
    "ffn": dict(d_model=16, d_ff=32, n_tokens=12),
}


@pytest.mark.parametrize("name", sorted(SMALL12))
def test_12bit_app_behav_matches_reference_entry_route(ref_fastapp, name):
    """12-bit app BEHAV on the entry route: the port on the CPU (K5's plain
    version, the per-config gather, the conv GEMM on synthesized planes)
    against the reference's ``app_behav_jax`` on its XLA entry route."""
    from repro.apps import APPLICATIONS as REF_APPS
    from repro_torch.apps import APPLICATIONS

    cfgs = _configs(12, 3, 71)
    want = ref_fastapp.app_behav_jax(REF_APPS[name](**SMALL12[name]), ref_spec_for(12), cfgs,
                                     ctx=_ref_ctx(kernel_impl="entry"))
    got = fastapp.app_behav_torch(APPLICATIONS[name](**SMALL12[name]), spec_for(12), cfgs,
                                  ctx=ExecutionContext(device="cpu", kernel_impl="entry"))
    np.testing.assert_array_equal(got, want)


def test_12bit_batches_take_the_table_free_routes_only():
    cfgs = _configs(12, 2, 72)
    batch = fastapp.table_batch(spec_for(12), cfgs, ctx=CPU)
    a, b = _codes(12, (4, 8), 73), _codes(12, (8, 3), 74)
    for impl in ("table", "plain", "gemm", None):
        with pytest.raises(ValueError, match="table-free"):
            fastapp.table_matmul_torch(batch, a, b, impl=impl)
    assert not batch.has_small
    with pytest.raises(ValueError, match="row tables stop"):
        batch.small
    per_config = np.stack([(a + i) % 4096 for i in range(len(cfgs))])
    got = fastapp.table_matmul_torch(batch, per_config, b, impl="entry_gather")
    want = app_kernels.planes_gemv_plain(batch.entry_small, _t(per_config), _t(b))
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="signed multipliers"):
        fastapp.table_batch(spec_for(14), _configs(12, 1, 0)[:, :1].repeat(105, 1), ctx=CPU)
    with pytest.raises(ValueError, match="at most 8 bits"):
        app_kernels.plan(40, 64, 10, 12)
    with pytest.raises(ValueError, match="takes 12-bit codes"):
        app_kernels.entry_gemv_wide(batch.masks[:, :4].contiguous(), _t(a), _t(b), 8)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES12) + ["mnist", "ffn", "ecg", "gauss"])
@pytest.mark.parametrize("n_cfgs", [64, 7])
def test_k5_12bit_matches_plain_on_card(cuda, shape, n_cfgs):
    """K5's 12-bit instance equals its plain version at the app shapes (D=64
    and a few configs, split over blocks) and where int32 sums wrap; each call
    counts one launch on ``entry_gemv_wide`` and none on the 8-bit design."""
    m, k, n = SHAPES12[shape] if shape in SHAPES12 else CARD_SHAPES[shape]
    cfgs = _configs(12, n_cfgs - 2, 81)
    batch = fastapp.table_batch(spec_for(12), cfgs, ctx=ExecutionContext())
    if shape == "wraps":
        a, b = _wrapping_codes((m, k), 82), _wrapping_codes((k, n), 83)
    else:
        a, b = _codes(12, (m, k), 82), _codes(12, (k, n), 83)
    a, b = _t(a).to(cuda), _t(b).to(cuda)
    before = (app_kernels.entry_gemv_wide.launches, app_kernels.entry_gemv.launches)
    got = app_kernels.entry_gemv(batch.masks, a, b, 12)
    torch.cuda.synchronize()
    assert (app_kernels.entry_gemv_wide.launches, app_kernels.entry_gemv.launches) == \
        (before[0] + 1, before[1])
    assert torch.equal(got, app_kernels.entry_gemv_plain(batch.masks, a, b, 12))
    assert app_kernels.entry_wide_splits(n_cfgs, m, k, n, 12) >= 1


@pytest.mark.gpu
def test_k5_12bit_launcher_refuses_what_it_cannot_hold_on_card(cuda):
    """One K-code's slots of N = 2,000 columns (384 KB) exceed a block's
    shared memory: the wrapper raises before any launch; 8-bit codes are
    not the wide instance's."""
    lib = app_kernels._lib()
    assert app_kernels.entry_wide_splits(4, 64, 16, 2000, 12) == 0
    assert app_kernels.entry_wide_splits(4, 64, 16, 1000, 12) >= 1
    assert app_kernels.entry_wide_splits(4, 64, 16, 10, 8) == 0
    masks = torch.zeros((4, 6), dtype=torch.int32, device=cuda)
    a = torch.zeros((64, 16), dtype=torch.int32, device=cuda)
    b = torch.zeros((16, 2000), dtype=torch.int32, device=cuda)
    out = torch.empty((4, 64, 2000), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.entry_gemv_wide_launch(masks.data_ptr(), a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), 4, 64, 16, 2000, 12, stream) != 0
    before = app_kernels.entry_gemv_wide.launches
    with pytest.raises(ValueError, match="K5 cannot take"):
        app_kernels.entry_gemv(masks, a, b, 12)
    assert app_kernels.entry_gemv_wide.launches == before
