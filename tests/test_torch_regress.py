"""The port's regression sentinel (``repro_torch.obs.regress``) against the reference's.

Synthetic bench reports only (the cases of ``tests/test_obs_regress.py``):
``compare``'s verdict, the CLI's exit codes and verdict JSON, the metric
parsing, the wall statistics and the history store must equal the
reference's exactly (the port's module is a stdlib copy).  The history
store is the port's own directory.
"""

import json
import os

import pytest

pytest.importorskip("jax")   # the reference package imports JAX; the card's host has none

from repro.obs import regress as ref  # noqa: E402

from repro_torch.obs import regress  # noqa: E402


def _suite(median, iqr=0.01, rows=()):
    return {"wall_s": median, "wall_s_min": median * 0.97, "wall_s_median": median,
            "wall_s_iqr": iqr, "repeats": 3, "rows": list(rows)}


def _report(suites, sha="abc1234"):
    return {"timestamp_utc": "2026-08-08T00:00:00Z", "git_sha": sha,
            "device": "cpu:cpux1", "quick": True, "seed": 0, "suites": suites}


def _dse_row(hv_ppf, hv_vpf):
    return {"name": "dse.fig12_sf0.5_ga", "us_per_call": 1e6,
            "derived": f"hv_ppf={hv_ppf:.5g} hv_vpf={hv_vpf:.5g} evals=1344"}


def _serving_row(top1, match):
    return {"name": "serving.axo_t1_r8_b4", "us_per_call": 1e6,
            "derived": f"12.3 tok/s match={match:.2f} top1={top1:.2f} rel=0.0123"}


_Q_BASE = _report({"dse": _suite(1.0, rows=[_dse_row(0.5, 0.4)]),
                   "serving": _suite(1.0, rows=[_serving_row(0.97, 0.9)])})
_FAILED = _report({"s": {"wall_s": 0.1, "failed": True}})

# (baseline, candidate, compare's keyword arguments)
CASES = {
    "verdicts": (
        _report({"same": _suite(1.0), "slow": _suite(1.0), "fast": _suite(1.0),
                 "gone": _suite(1.0)}),
        _report({"same": _suite(1.01), "slow": _suite(2.0), "fast": _suite(0.4),
                 "fresh": _suite(1.0)}, sha="def5678"), {}),
    "improved_passes": (_report({"fast": _suite(1.0)}), _report({"fast": _suite(0.4)}), {}),
    "noise_band_noisy": (_report({"noisy": _suite(1.0, iqr=0.2)}),
                         _report({"noisy": _suite(1.4, iqr=0.2)}),
                         {"wall_rel": 0.25, "iqr_mult": 3.0}),
    "noise_band_tight": (_report({"tight": _suite(1.0, iqr=0.01)}),
                         _report({"tight": _suite(1.4, iqr=0.01)}), {}),
    "noise_band_candidate_iqr": (_report({"s": _suite(1.0, iqr=0.01)}),
                                 _report({"s": _suite(1.4, iqr=0.2)}), {}),
    "quality_hv": (_Q_BASE, _report({"dse": _suite(1.0, rows=[_dse_row(0.5, 0.3)]),
                                     "serving": _suite(1.0, rows=[_serving_row(0.97, 0.9)])}),
                   {}),
    "quality_top1": (_Q_BASE, _report({
        "dse": _suite(1.0, rows=[_dse_row(0.5, 0.4)]),
        "serving": _suite(1.0, rows=[_serving_row(0.80, 0.9)])}), {}),
    "quality_wiggle": (_Q_BASE, _report({
        "dse": _suite(1.0, rows=[_dse_row(0.5, 0.396)]),
        "serving": _suite(1.0, rows=[_serving_row(0.95, 0.9)])}), {}),
    "warn_only_wall_and_hv": (
        _report({"slow": _suite(1.0), "dse": _suite(1.0, rows=[_dse_row(0.5, 0.4)])}),
        _report({"slow": _suite(3.0), "dse": _suite(1.0, rows=[_dse_row(0.5, 0.2)])}),
        {"wall_warn_only": True}),
    "warn_only_wall": (_report({"slow": _suite(1.0)}), _report({"slow": _suite(3.0)}),
                       {"wall_warn_only": True}),
    "failed_candidate": (_report({"s": _suite(1.0)}), _FAILED, {}),
    "failed_baseline": (_FAILED, _report({"s": _suite(1.0)}), {}),
    "pre_repeats": (_report({"s": {"wall_s": 1.0, "rows": []}}),
                    _report({"s": _suite(1.1)}), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_equals_the_reference(case):
    base, cand, kw = CASES[case]
    got = regress.compare(base, cand, **kw)
    assert got == ref.compare(base, cand, **kw)
    assert got["overall"] in ("PASS", "REGRESSED")


# CLI runs: (baseline, the candidates appended to the history in order, flags)
CLI_CASES = {
    "green_latest": (_report({"dse": _suite(1.0, rows=[_dse_row(0.5, 0.4)])}),
                     [_report({"dse": _suite(1.02, rows=[_dse_row(0.5, 0.4)])})],
                     ["--wall-warn-only"]),
    "red_latest": (_report({"dse": _suite(1.0, rows=[_dse_row(0.5, 0.4)])}),
                   [_report({"dse": _suite(1.02, rows=[_dse_row(0.5, 0.4)])}),
                    _report({"dse": _suite(1.0, rows=[_dse_row(0.5, 0.2)])})],
                   ["--wall-warn-only"]),
    "red_wall_gates": (_report({"slow": _suite(1.0)}), [_report({"slow": _suite(3.0)})], []),
    "empty_history": (_report({"s": _suite(1.0)}), [], []),
}


def _cli(module, tmp, base, cands, flags, capsys) -> tuple:
    os.makedirs(tmp, exist_ok=True)
    base_p = os.path.join(tmp, "baseline.json")
    with open(base_p, "w") as f:
        json.dump(base, f)
    hist = os.path.join(tmp, "hist")
    for c in cands:
        module.append_history(c, hist)
    out = os.path.join(tmp, "verdict.json")
    rc = module.main(["--baseline", base_p, "--candidate", "latest", "--history-dir", hist,
                      "--out", out, *flags])
    printed = capsys.readouterr()
    verdict = None
    if os.path.exists(out):
        with open(out) as f:
            verdict = json.load(f)
        for side in ("baseline", "candidate"):   # the paths differ by directory
            verdict[side].pop("path")
    return rc, verdict, printed.out


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_exit_codes_and_verdicts_equal_the_reference(case, tmp_path, capsys):
    base, cands, flags = CLI_CASES[case]
    got = _cli(regress, str(tmp_path / "port"), base, cands, flags, capsys)
    want = _cli(ref, str(tmp_path / "ref"), base, cands, flags, capsys)
    assert got == want
    assert got[0] == {"green_latest": 0, "red_latest": 1, "red_wall_gates": 1,
                      "empty_history": 2}[case]


@pytest.mark.parametrize("derived", [
    "hv_ppf=0.5 hv_vpf=4.5e-2 evals=1000 note=fast", "12.3 tok/s match=0.98", None, "",
])
def test_parse_metrics_equals_the_reference(derived):
    assert regress.parse_metrics(derived) == ref.parse_metrics(derived)


@pytest.mark.parametrize("walls", [[3.0, 1.0, 2.0], [5.0], [], [0.5, 0.7, 0.9, 3.0]])
def test_wall_stats_equal_the_reference(walls):
    assert regress.wall_stats(walls) == ref.wall_stats(walls)


def test_history_store_is_the_ports_own(tmp_path):
    assert regress.HISTORY_DIR != ref.HISTORY_DIR
    assert os.path.basename(regress.HISTORY_DIR) == "bench_history_torch" or \
        "REPRO_TORCH_BENCH_HISTORY" in os.environ
    d = str(tmp_path / "hist")
    assert regress.latest_report(d) is None
    p1 = regress.append_history(_report({"s": _suite(1.0)}), d)
    p2 = regress.append_history(_report({"s": _suite(2.0)}), d)
    assert p1 != p2 and regress.latest_report(d) == sorted([p1, p2])[-1]
    assert regress.load_report(p2) == ref.load_report(p2)
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    with pytest.raises(ValueError):
        regress.load_report(str(bad))
