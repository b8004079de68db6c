"""Tile autotuner for the kernel registry (``kernels.registry``).

Counterpart of ``repro/kernels/tuning.py``.  Every registered kernel with a
tunable space is searched per (kernel, device, shape bucket), and the winner
is persisted to an on-disk JSON cache, so a context constructed with
``ExecutionContext(tuning="cached")`` pays the search once per device and
every later process reuses the tuned tiles.

Policies (the context's ``tuning`` field):

  * ``"off"``    -- the registry's defaults (the engines' untuned choices);
                    never touches the cache.
  * ``"cached"`` -- the cached winner for this (kernel, device, bucket); on
                    a miss, search once and persist.
  * ``"search"`` -- ignore any persisted winner: search once per process per
                    bucket and overwrite the cache.

The search is gated: every candidate runs on the context's device against
the spec's oracle, its plain version, on the same inputs before it is timed.
Integer channels must be bit-identical and the f32 channel within the spec's
``tol``; a candidate that fails is rejected, and where every candidate fails
the defaults stand (the reference's contract; on the card such a rejection
is a kernel fault at that tile, which ``chip_smoke.py`` fails on).  The case
is the shape of the call that missed; on the CPU it is capped, as the
reference caps its interpret-mode cases.  Candidates are timed with CUDA
events over back-to-back calls after a warm-up on the card, and with the
host clock on the CPU (where the wrappers run their plain versions); the
default tiles are timed beside them.  The cache is keyed by device, so the
card re-tunes what the host tuned.

``tiles_for`` is the engines' entry point: ``core.fastchar``'s BEHAV
partials (K1, K2), ``apps.fastapp``'s table matmul (K4) and ``axo.deploy``
(K6) resolve their launch tiles through it.
"""

from __future__ import annotations

import json
import logging
import os
import platform
from collections.abc import MutableMapping

import numpy as np
import torch

from ..obs import telemetry as obs
from . import registry

logger = logging.getLogger("repro_torch.kernels.tuning")

__all__ = [
    "TUNING_POLICIES",
    "TuningCache",
    "cache_dir",
    "default_cache",
    "device_key",
    "cache_status",
    "parity_ok",
    "autotune",
    "tiles_for",
    "launch_overrides",
    "STATS",
    "reset_stats",
]

TUNING_POLICIES = ("off", "cached", "search")


class _StatsView(MutableMapping):
    """``STATS["searches"]``-style view of the ``tuning.*`` counters on the
    process-wide telemetry (``repro_torch.obs.GLOBAL``)."""

    _KEYS = {
        "searches": "tuning.search",
        "cache_hits": "tuning.cache_hit",
        "candidates_timed": "tuning.candidate_timed",
    }

    def __getitem__(self, key: str) -> int:
        return obs.GLOBAL.counter(self._KEYS[key])

    def __setitem__(self, key: str, value: int) -> None:
        obs.GLOBAL.set_counter(self._KEYS[key], value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("STATS keys are fixed")

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __repr__(self) -> str:
        return repr(dict(self))


STATS = _StatsView()

# In-process memo of resolved tiles: the JSON read of "cached" and the search
# of "search" happen at most once per (policy, kernel, device, bucket) per
# process.  "search" still ignores any winner on disk: a fresh process
# searches again, which is the policy's contract.
_MEMO: dict[str, dict] = {}

# CPU case caps: parity holds at any size, and host timings of the plain
# versions are a correctness proxy, so the host searches small cases
_CPU_CAPS = {"d": 64, "m": 64, "k": 256, "n": 64}
_CPU_AXO_CAPS = {"m": 32, "k": 192, "n": 160}
_TIMING_REPS = 3        # host clock: best of
_CUDA_ITERS = 20        # CUDA events: back-to-back calls averaged


def reset_stats() -> None:
    """Zero the tuning counters and drop the in-process memo (a fresh
    process against the same disk cache)."""
    for k in STATS:
        STATS[k] = 0
    obs.GLOBAL.set_counter("tuning.cache_miss", 0)
    obs.GLOBAL.set_counter("tuning.cache_corrupt", 0)
    _MEMO.clear()


# ---------------------------------------------------------------------------
# On-disk cache (one file a device)
# ---------------------------------------------------------------------------


def _sanitize(s: str) -> str:
    return "".join(c if c.isalnum() or c in "-." else "_" for c in s)


def device_key(device=None) -> str:
    """``cuda:<card name>_sm<major><minor>`` of the device (the current card
    by default where one answers), ``cpu:<arch>`` on the host."""
    device = torch.device("cuda" if device is None and torch.cuda.is_available()
                          else device or "cpu")
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        major, minor = torch.cuda.get_device_capability(index)
        return f"cuda:{_sanitize(torch.cuda.get_device_name(index))}_sm{major}{minor}"
    return f"cpu:{_sanitize(platform.machine() or 'unknown')}"


class TuningCache:
    """JSON tile cache ``{cache key: {"tiles": {...}, meta...}}`` of one device.

    Writes are atomic (a temporary file, then a replace), so concurrent
    tuners at worst lose a record, never corrupt the file.  A file that does
    not parse warns, counts ``tuning.cache_corrupt`` and reads as empty, so
    every bucket re-tunes.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._data: dict | None = None

    def _load(self) -> dict:
        if self._data is None:
            try:
                with open(self.path) as f:
                    self._data = json.load(f)
            except FileNotFoundError:
                self._data = {}  # the device's first run: normal
            except (OSError, ValueError) as exc:
                logger.warning("tuning cache %s unreadable (%s: %s) -- ignoring it and "
                               "re-tuning", self.path, type(exc).__name__, exc)
                obs.current().count("tuning.cache_corrupt")
                self._data = {}
        return self._data

    def get(self, key: str) -> dict | None:
        return self._load().get(key)

    def put(self, key: str, record: dict) -> None:
        data = self._load()
        data[key] = record
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)


def cache_dir() -> str:
    """``$REPRO_TUNING_CACHE``, default ``experiments/cache/kernel_tuning``."""
    return os.environ.get("REPRO_TUNING_CACHE",
                          os.path.join("experiments", "cache", "kernel_tuning"))


def default_cache(device=None) -> TuningCache:
    """The device's cache file under :func:`cache_dir`."""
    fname = device_key(device).replace(":", "_") + ".json"
    return TuningCache(os.path.join(cache_dir(), fname))


def _cache_key(spec: registry.KernelSpec, bucket, dev_key: str) -> str:
    return f"{spec.name}|{dev_key}|{'x'.join(str(b) for b in bucket)}"


def cache_status(cache: TuningCache | None = None) -> dict:
    """Health of the on-disk tuning cache (the ``/healthz`` entry): its path,
    whether it exists, its winners and the process's cache counters.  Never
    raises: a failure reads ``{"ok": False, "error": ...}``."""
    try:
        cache = cache or default_cache()
        entries = len(cache._load())
        exists = os.path.exists(cache.path)
    except Exception as exc:
        return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    return {
        "ok": True,
        "path": cache.path,
        "exists": exists,
        "entries": entries,
        "hits": obs.GLOBAL.counter("tuning.cache_hit"),
        "misses": obs.GLOBAL.counter("tuning.cache_miss"),
        "searches": obs.GLOBAL.counter("tuning.search"),
        "corrupt": obs.GLOBAL.counter("tuning.cache_corrupt"),
    }


# ---------------------------------------------------------------------------
# Search harnesses: a deterministic case at a shape, the wrapper at a tile
# and the plain version, each returning (exact channels, close channels)
# ---------------------------------------------------------------------------


def _configs(n_bits: int, d: int, seed: int) -> np.ndarray:
    from ..core.operator_model import spec_for

    rng = np.random.default_rng(seed)
    cfgs = rng.integers(0, 2, (d, spec_for(n_bits).n_luts)).astype(np.uint8)
    cfgs[0] = 0
    cfgs[-1] = 1
    return cfgs


def _char_case(shape: dict, device) -> dict:
    from ..core import fastchar
    from ..core.operator_model import config_to_masks, spec_for

    n_bits, d = shape["n_bits"], shape["d"]
    spec = spec_for(n_bits)
    masks = torch.from_numpy(config_to_masks(spec, _configs(n_bits, d, n_bits * 1000 + d))
                             .astype(np.int32)).to(device)
    _, exact, w = fastchar._device_tables(n_bits, str(device))
    return {"spec": spec, "masks": masks, "small": fastchar._gather_small(masks, n_bits),
            "exact": exact, "w": w}


def _char_channels(case, partials):
    from ..core import fastchar

    int_p, rel_p = partials
    out = fastchar._combine(case["spec"], int_p.cpu().numpy(), rel_p.cpu().numpy(),
                            case["masks"].shape[0])
    return ((out["AVG_ABS_ERR"], out["PROB_ERR"], out["MAX_ABS_ERR"], out["MSE"]),
            (out["AVG_ABS_REL_ERR"],))


def _run_char(spec, case, tiles):
    from . import char_kernels

    if spec.impl == "entry":
        return char_kernels.behav_stats_entry(case["masks"], case["spec"].n_bits,
                                              tiles["a_tile"], tiles["configs"])
    return char_kernels.behav_stats_table(case["small"], case["exact"], case["w"],
                                          tiles["a_tile"])


def _oracle_char(spec, case):
    from . import char_kernels

    from ..core.fastchar import default_a_tile

    a_tile = default_a_tile(case["spec"])
    if spec.impl == "entry":
        return char_kernels.behav_stats_entry_plain(case["masks"], case["spec"].n_bits, a_tile)
    return char_kernels.behav_stats_table_plain(case["small"], case["exact"], case["w"], a_tile)


def _app_case(shape: dict, device) -> dict:
    from ..apps.fastapp import table_batch
    from ..core.engine import ExecutionContext
    from ..core.operator_model import spec_for

    n_bits, d, m, k, n = (shape[x] for x in ("n_bits", "d", "m", "k", "n"))
    spec = spec_for(n_bits)
    batch = table_batch(spec, _configs(n_bits, d, n_bits * 100 + m + k + n),
                        ExecutionContext(device=str(device)))
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    a = torch.from_numpy(rng.integers(0, spec.n_inputs, (m, k)).astype(np.int32)).to(device)
    b = torch.from_numpy(rng.integers(0, spec.n_inputs, (k, n)).astype(np.int32)).to(device)
    return {"tables": batch.tables.reshape(d, -1).contiguous(), "a": a, "b": b}


def _run_app(spec, case, tiles):
    from . import app_kernels

    return app_kernels.table_gemv(case["tables"], case["a"], case["b"], tiles["route"],
                                  tiles["m_tile"] or None, tiles["k_tile"] or None)


def _oracle_app(spec, case):
    from . import app_kernels

    return app_kernels.table_gemv_plain(case["tables"], case["a"], case["b"])


def _axo_case(shape: dict, device) -> dict:
    from ..axo.deploy import AxOOperator, _tables

    m, k, n, rank = shape["m"], shape["k"], shape["n"], shape["rank"]
    op = AxOOperator.from_config(_configs(8, 1, 11)[0], rank=rank)
    rng = np.random.default_rng(m + 3 * k + 7 * n + rank)
    a = torch.from_numpy(rng.integers(0, 256, (m, k)).astype(np.uint8)).to(device)
    b = torch.from_numpy(rng.integers(0, 256, (k, n)).astype(np.uint8)).to(device)
    # outputs are O(k * qmax^2): normalized so that the spec's tol gates relative error
    return {"args": (a, b, *_tables(op, device)), "scale": float(k) * 127.0 * 127.0}


def _run_axo(spec, case, tiles):
    from . import axo_matmul

    return axo_matmul.axo_matmul(*case["args"], splits=tiles["splits"])


def _oracle_axo(spec, case):
    from . import axo_matmul

    return axo_matmul.axo_matmul_plain(*case["args"])


def _int_channels(case, out):
    return ((out.cpu().numpy(),), ())


def _axo_channels(case, out):
    return ((), (out.double().cpu().numpy() / case["scale"],))


# engine -> (case maker, wrapper at tiles, plain version, channels)
_HARNESS = {
    "fastchar": (_char_case, _run_char, _oracle_char, _char_channels),
    "fastapp": (_app_case, _run_app, _oracle_app, _int_channels),
    "axo_matmul": (_axo_case, _run_axo, _oracle_axo, _axo_channels),
}


def _case_shape(spec: registry.KernelSpec, shape: dict, device) -> dict:
    """The search case's shape: the call's, capped on the CPU."""
    if torch.device(device).type == "cuda":
        return dict(shape)
    caps = _CPU_AXO_CAPS if spec.engine == "axo_matmul" else _CPU_CAPS
    return {k: min(v, caps[k]) if k in caps else v for k, v in shape.items()}


def _channels_ok(spec, got, want) -> bool:
    for r, o in zip(got[0], want[0]):
        if not np.array_equal(np.asarray(r), np.asarray(o)):
            return False
    for r, o in zip(got[1], want[1]):
        if not np.allclose(np.asarray(r), np.asarray(o), rtol=spec.tol, atol=spec.tol):
            return False
    return True


def parity_ok(spec: registry.KernelSpec, tiles: dict, device="cuda", **shape) -> bool:
    """Whether ``spec``'s wrapper at ``tiles`` agrees with its plain version
    on the deterministic case at ``shape`` on ``device``: integer channels
    bit-identical, f32 channels within the spec's ``tol``.  Its launches,
    like the search's, record nothing on any telemetry."""
    make, run, oracle, channels = _HARNESS[spec.engine]
    with obs.use(obs.NULL):
        case = make(shape, torch.device(device))
        return _channels_ok(spec, channels(case, run(spec, case, tiles)),
                            channels(case, oracle(spec, case)))


def _time_us(fn, device) -> float:
    """Microseconds a call (``obs.profile.time_ms``): CUDA events on the card,
    the host clock on the CPU."""
    from ..obs.profile import time_ms

    return 1e3 * time_ms(fn, device, _CUDA_ITERS if device.type == "cuda" else _TIMING_REPS)


def _label(tiles: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in tiles.items())


def autotune(spec: registry.KernelSpec, device="cuda", **shape) -> dict:
    """Search ``spec``'s admissible tiles at ``shape`` on ``device``.

    Every candidate is held to the plain version first, then timed; the
    default tiles are timed as well.  Returns the cache record::

        {"tiles": {...}, "us": float, "device": str, "shape": {...},
         "candidates": int, "rejected": int, "rejected_tiles": [...],
         "timings": {"a_tile=..": us, ...}, "default": {"tiles": ..., "us": ...}}
    """
    tel = obs.current()
    tel.count("tuning.search")
    device = torch.device(device)
    case_shape = _case_shape(spec, shape, device)
    cands = spec.candidates(**case_shape)
    default = spec.default_tiles(**case_shape)
    record = {"tiles": spec.default_tiles(**shape), "us": None, "device": device_key(device),
              "shape": case_shape, "candidates": len(cands), "rejected": 0,
              "rejected_tiles": [], "timings": {}, "default": {"tiles": default, "us": None}}
    if not cands:
        return record
    make, run, oracle, channels = _HARNESS[spec.engine]
    best, best_us = None, float("inf")
    # the candidates' launches are no path's: the wrappers' once-a-shape
    # bookkeeping (jit.retrace.*, *.pad_waste) stays off every sink
    with obs.use(obs.NULL):
        case = make(case_shape, device)
        want = channels(case, oracle(spec, case))
        for tiles in cands:
            if not _channels_ok(spec, channels(case, run(spec, case, tiles)), want):
                record["rejected"] += 1
                record["rejected_tiles"].append(tiles)
                continue
            us = _time_us(lambda: run(spec, case, tiles), device)
            tel.count("tuning.candidate_timed")
            record["timings"][_label(tiles)] = us
            if us < best_us:
                best, best_us = tiles, us
        record["default"]["us"] = record["timings"].get(_label(default))
        if record["default"]["us"] is None:
            record["default"]["us"] = _time_us(lambda: run(spec, case, default), device)
    if best is not None:
        record["tiles"], record["us"] = best, best_us
    return record


def tiles_for(ctx, name: str, cache: TuningCache | None = None, **shape) -> dict:
    """Launch tiles of kernel ``name`` at ``shape`` under ``ctx``'s policy.

    ``ctx`` is an ``ExecutionContext`` or None (None and ``tuning="off"``
    give the registry's defaults).  A spec without tunables answers its
    defaults under every policy.  A bucket's winner that the constraint
    does not admit at this exact shape (it was searched at another shape of
    the bucket) gives way to the defaults, counted as
    ``tuning.inadmissible``.  Engines call this where they launch
    (``"search"`` launches kernels on ``ctx.device``).
    """
    tiles = _resolve(ctx, name, cache, shape)
    spec = registry.get(name)
    if spec.constraint is not None and tiles != spec.default_tiles(**shape) \
            and not spec.constraint(shape, tiles):
        obs.of(ctx).count("tuning.inadmissible")
        return spec.default_tiles(**shape)
    return tiles


def launch_overrides(ctx, name: str, **shape) -> dict:
    """:func:`tiles_for`'s tiles where they differ from the registry's
    defaults at ``shape``, else ``{}``.  A wrapper's own defaults are the
    registry's, so an engine that passes these calls its wrapper untuned
    exactly as it did before the registry existed."""
    tiles = tiles_for(ctx, name, **shape)
    return {} if tiles == registry.get(name).default_tiles(**shape) else tiles


def _resolve(ctx, name: str, cache: TuningCache | None, shape: dict) -> dict:
    spec = registry.get(name)
    tel = obs.of(ctx)
    tel.count(f"registry.dispatch.{name}")
    policy = getattr(ctx, "tuning", None) or "off"
    if policy not in TUNING_POLICIES:
        raise ValueError(f"unknown tuning policy {policy!r}")
    if policy == "off" or not spec.tunables:
        return spec.default_tiles(**shape)
    device = torch.device(ctx.device)
    key = _cache_key(spec, spec.bucket(**shape), device_key(device))
    memo_key = f"{policy}|{key}" if cache is None else None
    if memo_key is not None and memo_key in _MEMO:
        return dict(_MEMO[memo_key])
    cache = cache or default_cache(device)
    if policy == "cached":
        rec = cache.get(key)
        if rec is not None:
            tel.count("tuning.cache_hit")
            tiles = dict(rec["tiles"])
            if memo_key is not None:
                _MEMO[memo_key] = tiles
            return dict(tiles)
        tel.count("tuning.cache_miss")
    with tel.span(f"tuning.autotune.{name}", bucket=list(spec.bucket(**shape))), obs.use(tel):
        rec = autotune(spec, device, **shape)
    cache.put(key, rec)
    tiles = dict(rec["tiles"])
    if memo_key is not None:
        _MEMO[memo_key] = tiles
    return dict(tiles)
