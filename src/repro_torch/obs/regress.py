"""Bench regression sentinel: a history store and a noise-aware PASS/REGRESSED gate.

Counterpart of ``repro/obs/regress.py``, a stdlib-only copy: report JSONs
in, a verdict out.  It is the analysis half of a benchmark:

  * a **history store** -- every report is appended (timestamped, never
    overwritten) under ``experiments/bench_history_torch/`` (the port's own,
    never the reference's; ``$REPRO_TORCH_BENCH_HISTORY`` overrides it), so
    a machine's perf trajectory survives across runs,
  * a **regression detector** -- :func:`compare` matches a candidate report
    against a baseline suite by suite and issues one verdict per suite,
    gating both wall-clock and quality metrics:

      - wall-clock uses **noise-aware bands**: a suite counts as regressed
        or improved only when the median moves by more than
        ``max(wall_rel * baseline_median, iqr_mult * max(IQRs))``: the IQR
        of the repeated trials is the noise floor,
      - quality metrics (DSE/app hypervolume, serving teacher-forced top-1,
        free-run match) are parsed out of the rows' ``derived`` strings via
        :data:`QUALITY_GATES` and compared with relative tolerances; at a
        fixed seed these are deterministic, so drift means the behaviour
        changed.

  * a **CLI**::

        python -m repro_torch.obs.regress --baseline BASELINE.json \\
            [--candidate PATH|latest] [--out verdict.json] [--wall-warn-only]

    Exit status is non-zero iff the overall verdict is REGRESSED.  With
    ``--wall-warn-only`` wall-clock regressions are reported but demoted to
    warnings (shared runners); quality regressions always fail.

It reads whatever report a caller passes (the reference's report format);
which reports the port writes is its benchmark's business.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

__all__ = [
    "HISTORY_DIR",
    "QUALITY_GATES",
    "append_history",
    "latest_report",
    "load_report",
    "parse_metrics",
    "wall_stats",
    "compare",
    "main",
]

#: where every bench run lands (gitignored; env-overridable): the port's own
HISTORY_DIR = os.environ.get(
    "REPRO_TORCH_BENCH_HISTORY", os.path.join("experiments", "bench_history_torch")
)

# verdict strings, worst first (suite verdict = worst of its checks)
_ORDER = ("REGRESSED", "IMPROVED", "NEW", "SKIPPED", "PASS")

#: quality gates: (row-name regex, metric key in the derived string,
#: direction, relative tolerance).  ``higher`` means larger is better.
QUALITY_GATES: tuple = (
    # DSE hypervolume (paper Figs. 12/13): PPF = estimated, VPF = validated
    (r"^dse\.fig12_.*_(ga|map|map\+ga)$", "hv_vpf", "higher", 0.02),
    (r"^dse\.fig12_.*_(ga|map|map\+ga)$", "hv_ppf", "higher", 0.02),
    # application-level DSE fronts (Figs. 16-19)
    (r"^apps\.fig16_.*", "hv_vpf", "higher", 0.02),
    # serving: teacher-forced top-1 agreement and free-run token match on
    # real generations (bench_serving); top1 is the headline BEHAV gate
    (r"^serving\.axo_", "top1", "higher", 0.05),
    (r"^serving\.axo_", "match", "higher", 0.10),
    # DSE service (bench_service): deterministic at fixed seed -- the cold
    # sweep and its replay must reproduce the same validated hypervolume
    (r"^service\.(cold_sweep|warm_replay)$", "hv_vpf", "higher", 0.02),
)

_METRIC_RE = re.compile(r"([A-Za-z_][\w]*)=([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)")


def parse_metrics(derived) -> dict[str, float]:
    """Numeric ``key=value`` tokens of a row's ``derived`` string.

    ``"hv_ppf=0.123 hv_vpf=4.5e-2 evals=1000"`` -> three floats; non-numeric
    values and bare numbers (``"12.3 tok/s"``) are ignored.
    """
    if not isinstance(derived, str):
        return {}
    return {k: float(v) for k, v in _METRIC_RE.findall(derived)}


def wall_stats(walls) -> dict:
    """min / median / IQR of repeated suite wall-times (``run.py --repeats``)."""
    xs = sorted(float(w) for w in walls)
    n = len(xs)
    if not n:
        return {"wall_s": 0.0, "wall_s_min": 0.0, "wall_s_median": 0.0,
                "wall_s_iqr": 0.0, "repeats": 0}

    def q(f: float) -> float:  # linear-interpolated quantile
        pos = f * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])

    med = q(0.5)
    return {
        "wall_s": round(med, 4),
        "wall_s_min": round(xs[0], 4),
        "wall_s_median": round(med, 4),
        "wall_s_iqr": round(q(0.75) - q(0.25), 4),
        "repeats": n,
    }


# ---------------------------------------------------------------------------
# History store
# ---------------------------------------------------------------------------


def append_history(report: dict, history_dir: str | None = None) -> str:
    """Append one bench report to the history store (never overwrites).

    File names carry a UTC timestamp down to seconds plus the pid; if a
    same-second same-pid file already exists a zero-padded sequence suffix
    is added (``_001``, sorting after the bare name), so appends never
    collide and lexicographic order stays chronological.
    """
    d = history_dir or HISTORY_DIR
    os.makedirs(d, exist_ok=True)
    stamp = time.strftime("%Y-%m-%dT%H%M%SZ", time.gmtime())
    base = os.path.join(d, f"BENCH_{stamp}_{os.getpid()}")
    path = base + ".json"
    seq = 0
    while os.path.exists(path):
        seq += 1
        path = f"{base}_{seq:03d}.json"
    with open(path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def latest_report(history_dir: str | None = None) -> str | None:
    """Path of the newest report in the history store (lexicographic ==
    chronological with the timestamped names), or None when empty."""
    d = history_dir or HISTORY_DIR
    paths = sorted(glob.glob(os.path.join(d, "BENCH_*.json")))
    return paths[-1] if paths else None


def load_report(path: str) -> dict:
    with open(path) as f:
        rep = json.load(f)
    if "suites" not in rep:
        raise ValueError(f"{path}: not a bench report (no 'suites' key)")
    return rep


# ---------------------------------------------------------------------------
# The detector
# ---------------------------------------------------------------------------


def _suite_walls(entry: dict) -> tuple[float, float]:
    """(median, iqr) of a suite entry; pre-repeats reports fall back to the
    single-shot ``wall_s`` with zero IQR."""
    med = float(entry.get("wall_s_median", entry.get("wall_s", 0.0)))
    return med, float(entry.get("wall_s_iqr", 0.0))


def _row_metrics(entry: dict) -> dict[str, dict[str, float]]:
    """{row name: {metric: value}} for every gated quality metric of a suite."""
    out: dict[str, dict[str, float]] = {}
    for r in entry.get("rows") or ():
        name = r.get("name", "")
        vals = parse_metrics(r.get("derived"))
        if not vals:
            continue
        for pat, key, _direction, _tol in QUALITY_GATES:
            if key in vals and re.search(pat, name):
                out.setdefault(name, {})[key] = vals[key]
    return out


def _gate_for(name: str, key: str):
    for pat, k, direction, tol in QUALITY_GATES:
        if k == key and re.search(pat, name):
            return direction, tol
    return None


def _compare_wall(base: dict, cand: dict, wall_rel: float, iqr_mult: float) -> dict:
    b_med, b_iqr = _suite_walls(base)
    c_med, c_iqr = _suite_walls(cand)
    band = max(wall_rel * b_med, iqr_mult * max(b_iqr, c_iqr))
    delta = c_med - b_med
    if delta > band:
        status = "REGRESSED"
    elif -delta > band:
        status = "IMPROVED"
    else:
        status = "PASS"
    return {
        "status": status,
        "baseline_s": b_med,
        "candidate_s": c_med,
        "band_s": round(band, 4),
        "delta_rel": round(delta / b_med, 4) if b_med > 0 else 0.0,
    }


def _compare_quality(base: dict, cand: dict) -> list[dict]:
    b_rows = _row_metrics(base)
    c_rows = _row_metrics(cand)
    checks: list[dict] = []
    for name in sorted(set(b_rows) & set(c_rows)):
        for key in sorted(set(b_rows[name]) & set(c_rows[name])):
            direction, tol = _gate_for(name, key)
            b, c = b_rows[name][key], c_rows[name][key]
            lo = abs(b) * tol
            worse = (b - c) if direction == "higher" else (c - b)
            if worse > lo:
                status = "REGRESSED"
            elif -worse > lo:
                status = "IMPROVED"
            else:
                status = "PASS"
            checks.append({
                "row": name, "metric": key, "status": status,
                "baseline": b, "candidate": c, "tol_rel": tol,
                "direction": direction,
            })
    return checks


def _worst(statuses) -> str:
    statuses = list(statuses) or ["PASS"]
    return min(statuses, key=_ORDER.index)


def compare(
    baseline: dict,
    candidate: dict,
    *,
    wall_rel: float = 0.25,
    iqr_mult: float = 3.0,
    wall_warn_only: bool = False,
) -> dict:
    """The verdict of ``candidate`` measured against ``baseline``.

    Suites present in both reports get a wall-clock check plus one quality
    check per gated metric; suites only in the candidate are ``NEW`` (not a
    failure -- coverage grew), suites only in the baseline are ``SKIPPED``
    (the candidate was a subset run).  A suite that *failed* in the candidate
    is always ``REGRESSED``.  ``overall`` is ``REGRESSED`` iff any gating
    check regressed -- quality always gates; wall-clock gates unless
    ``wall_warn_only`` (then wall regressions land in ``warnings``).
    """
    b_suites = baseline.get("suites", {})
    c_suites = candidate.get("suites", {})
    suites: dict[str, dict] = {}
    warnings: list[str] = []
    gating_failures: list[str] = []

    for name in sorted(set(b_suites) | set(c_suites)):
        base, cand = b_suites.get(name), c_suites.get(name)
        if base is None:
            suites[name] = {"status": "NEW"}
            continue
        if cand is None:
            suites[name] = {"status": "SKIPPED"}
            continue
        if cand.get("failed"):
            suites[name] = {"status": "REGRESSED", "reason": "suite failed"}
            gating_failures.append(f"{name}: suite failed")
            continue
        if base.get("failed"):
            suites[name] = {"status": "NEW", "reason": "baseline suite failed"}
            continue
        wall = _compare_wall(base, cand, wall_rel, iqr_mult)
        quality = _compare_quality(base, cand)
        q_status = _worst(c["status"] for c in quality)
        statuses = [wall["status"], q_status]
        suites[name] = {
            "status": _worst(statuses),
            "wall": wall,
            "quality": quality,
        }
        for c in quality:
            if c["status"] == "REGRESSED":
                gating_failures.append(
                    f"{name}: {c['row']} {c['metric']} "
                    f"{c['baseline']:.6g} -> {c['candidate']:.6g}"
                )
        if wall["status"] == "REGRESSED":
            msg = (f"{name}: wall {wall['baseline_s']:.3f}s -> "
                   f"{wall['candidate_s']:.3f}s (band {wall['band_s']:.3f}s)")
            if wall_warn_only:
                warnings.append(msg)
            else:
                gating_failures.append(msg)

    return {
        "overall": "REGRESSED" if gating_failures else "PASS",
        "failures": gating_failures,
        "warnings": warnings,
        "suites": suites,
        "thresholds": {
            "wall_rel": wall_rel,
            "iqr_mult": iqr_mult,
            "wall_warn_only": wall_warn_only,
        },
        "baseline": {
            "git_sha": baseline.get("git_sha"),
            "device": baseline.get("device"),
            "timestamp_utc": baseline.get("timestamp_utc"),
        },
        "candidate": {
            "git_sha": candidate.get("git_sha"),
            "device": candidate.get("device"),
            "timestamp_utc": candidate.get("timestamp_utc"),
        },
    }


# ---------------------------------------------------------------------------
# CLI (the CI perf-sentinel entry point)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="Gate a bench run against a committed baseline.",
    )
    ap.add_argument("--baseline", required=True,
                    help="baseline report (a JSON of the reference's report format)")
    ap.add_argument("--candidate", default="latest",
                    help="candidate report path, or 'latest' for the newest "
                         "entry in the bench history store")
    ap.add_argument("--history-dir", default=None,
                    help=f"history store (default {HISTORY_DIR})")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the machine-readable verdict JSON here")
    ap.add_argument("--wall-rel", type=float, default=0.25,
                    help="min relative wall-clock move to count (default 0.25)")
    ap.add_argument("--iqr-mult", type=float, default=3.0,
                    help="noise band = this many IQRs (default 3)")
    ap.add_argument("--wall-warn-only", action="store_true",
                    help="wall-clock regressions warn instead of failing "
                         "(quality metrics still hard-fail)")
    args = ap.parse_args(argv)

    cand_path = args.candidate
    if cand_path == "latest":
        cand_path = latest_report(args.history_dir)
        if cand_path is None:
            print("regress: no candidate report in history "
                  f"({args.history_dir or HISTORY_DIR}); run benchmarks first",
                  file=sys.stderr)
            return 2

    verdict = compare(
        load_report(args.baseline),
        load_report(cand_path),
        wall_rel=args.wall_rel,
        iqr_mult=args.iqr_mult,
        wall_warn_only=args.wall_warn_only,
    )
    verdict["candidate"]["path"] = cand_path
    verdict["baseline"]["path"] = args.baseline

    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdict, f, indent=2, sort_keys=True)
            f.write("\n")

    for name, s in sorted(verdict["suites"].items()):
        line = f"{s['status']:9s} {name}"
        wall = s.get("wall")
        if wall:
            line += (f"  wall {wall['baseline_s']:.3f}s -> "
                     f"{wall['candidate_s']:.3f}s ({wall['delta_rel']:+.1%},"
                     f" band {wall['band_s']:.3f}s)")
        print(line)
        for c in s.get("quality", ()):
            if c["status"] != "PASS":
                print(f"          {c['status']}: {c['row']} {c['metric']} "
                      f"{c['baseline']:.6g} -> {c['candidate']:.6g}")
    for w in verdict["warnings"]:
        print(f"WARNING (non-gating): {w}")
    print(f"overall: {verdict['overall']}")
    if verdict["failures"]:
        for msg in verdict["failures"]:
            print(f"FAIL: {msg}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
