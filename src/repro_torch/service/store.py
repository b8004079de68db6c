"""Content-addressed operator library: characterized rows + validated fronts.

Counterpart of ``repro/service/store.py``, with the same schema and key
payloads, so a key here equals the reference's for the same inputs and a
library the reference wrote reads back here.

Every record is keyed by a sha256 over a canonical (sorted-key, separator-
stable) JSON payload of ``(schema, spec.tag, config bits, app, const_sf)`` --
stable across processes, Python hash randomization, and dict-key order.  Two
append-only JSONL shards live under :func:`library_dir` (default
``experiments/library/``, overridable via ``REPRO_OPERATOR_LIBRARY``):

- ``rows.jsonl``   -- one characterized config per line (true BEHAV/PPA), the
  dedup cache that lets ``run_dse``'s validation skip the fastchar dispatch
  for already-known configs.
- ``fronts.jsonl`` -- one validated front per line (VPF configs/objs + hv,
  plus the estimated PPF), doubling as the full-request result cache (records
  carry the request digest) and the warm-start corpus
  (:meth:`OperatorStore.warm_pool`).

Corrupt or truncated lines never crash a reader: they are skipped with a
warning and a ``service.store_corrupt`` count.  Writers append whole lines with a flush per record; a torn
final line (killed process) is exactly the case the reader tolerates.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings

import numpy as np

from .. import obs

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_OPERATOR_LIBRARY"

_ROWS_SHARD = "rows.jsonl"
_FRONTS_SHARD = "fronts.jsonl"


def library_dir() -> str:
    """On-disk library root (``REPRO_OPERATOR_LIBRARY`` overrides)."""
    return os.environ.get(ENV_VAR, os.path.join("experiments", "library"))


def _digest(payload: dict) -> str:
    """sha256 over canonical JSON: sorted keys, fixed separators, ASCII."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode("ascii")).hexdigest()


def _bits(config) -> str:
    return "".join("1" if int(b) else "0" for b in np.asarray(config).ravel())


def _unbits(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), np.uint8) - ord("0")


def config_key(spec, config, app: str | None = None,
               const_sf: float | None = None) -> str:
    """Content address of one characterized config.

    ``app=None`` is operator-level characterization; ``const_sf`` is part of
    the address only where the stored value depends on it (fronts) -- row
    lookups pass ``None`` because BEHAV/PPA of a config does not.
    """
    return _digest({
        "schema": SCHEMA_VERSION,
        "kind": "row",
        "spec": spec.tag,
        "config": _bits(config),
        "app": app,
        "const_sf": None if const_sf is None else round(float(const_sf), 9),
    })


def request_key(spec, app: str | None, const_sf: float, seed: int,
                method: str, settings=None, train_fingerprint: str | None = None,
                ) -> str:
    """Content address of one full DSE request (the result-cache key).

    Includes everything that changes the deterministic output: the operator,
    app, constraint factor, seed, method, the search budget + objective keys
    from ``settings``, and a fingerprint of the training dataset (estimators,
    reference point and constraint bounds all derive from it).
    """
    payload = {
        "schema": SCHEMA_VERSION,
        "kind": "request",
        "spec": spec.tag,
        "app": app,
        "const_sf": round(float(const_sf), 9),
        "seed": int(seed),
        "method": method,
        "train": train_fingerprint,
    }
    if settings is not None:
        payload["budget"] = {
            "pop_size": settings.pop_size,
            "n_gen": settings.n_gen,
            "behav_key": settings.behav_key,
            "ppa_key": settings.ppa_key,
            "n_estimator_quad": settings.n_estimator_quad,
        }
    return _digest(payload)


def train_fingerprint(train_ds) -> str:
    """Stable digest of a training dataset (configs + metric arrays)."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(train_ds.configs).tobytes())
    for name in sorted(train_ds.metrics):
        h.update(name.encode("ascii"))
        h.update(np.ascontiguousarray(train_ds.metrics[name]).tobytes())
    return h.hexdigest()


class OperatorStore:
    """The persistent, content-addressed operator library.

    Lazily loads both shards on first access; tolerates missing files, corrupt
    lines and unknown schema versions (warn + ``service.store_corrupt``, never
    raise).  All mutation goes through :meth:`put_rows` / :meth:`put_front`,
    which append to disk and update the in-memory index in one step.
    """

    def __init__(self, root: str | None = None, tel=None):
        self.root = root or library_dir()
        self._tel = tel
        self._rows: dict[str, dict] | None = None      # key -> record
        self._fronts: list[dict] | None = None
        self._requests: dict[str, dict] = {}           # request digest -> front record

    # -- telemetry ----------------------------------------------------------

    @property
    def tel(self):
        return self._tel if self._tel is not None else obs.current()

    def _gauge_sizes(self) -> None:
        tel = self.tel
        tel.gauge("service.library_size", float(len(self._rows or ())))
        tel.gauge("service.front_count", float(len(self._fronts or ())))

    # -- shard IO ------------------------------------------------------------

    def _path(self, shard: str) -> str:
        return os.path.join(self.root, shard)

    def _read_shard(self, shard: str) -> list[dict]:
        path = self._path(shard)
        try:
            with open(path, "r", encoding="ascii") as fh:
                lines = fh.readlines()
        except FileNotFoundError:
            return []
        except OSError as exc:
            warnings.warn(f"operator library shard {path} unreadable ({exc}); "
                          "treating as empty", stacklevel=3)
            self.tel.count("service.store_corrupt")
            return []
        records: list[dict] = []
        bad = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or rec.get("schema") != SCHEMA_VERSION:
                    raise ValueError(f"schema {rec.get('schema')!r}"
                                     if isinstance(rec, dict) else "not a record")
                records.append(rec)
            except (ValueError, TypeError):
                bad += 1
        if bad:
            warnings.warn(f"operator library shard {path}: skipped {bad} "
                          "corrupt/unknown-schema line(s)", stacklevel=3)
            self.tel.count("service.store_corrupt", bad)
        return records

    def _append(self, shard: str, records: list[dict]) -> None:
        if not records:
            return
        os.makedirs(self.root, exist_ok=True)
        path = self._path(shard)
        with open(path, "a", encoding="ascii") as fh:
            for rec in records:
                fh.write(json.dumps(rec, sort_keys=True,
                                    separators=(",", ":")) + "\n")
            fh.flush()

    def _load(self) -> None:
        if self._rows is not None:
            return
        self._rows = {r["key"]: r for r in self._read_shard(_ROWS_SHARD)}
        self._fronts = self._read_shard(_FRONTS_SHARD)
        self._requests = {
            r["request"]: r for r in self._fronts if r.get("request")
        }
        self._gauge_sizes()

    # -- characterized rows ---------------------------------------------------

    def lookup_rows(
        self, spec, configs: np.ndarray, app: str | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(objs (D, 2) float64, hit (D,) bool): cached BEHAV/PPA per config."""
        self._load()
        D = len(configs)
        objs = np.zeros((D, 2), np.float64)
        hit = np.zeros(D, bool)
        for i, cfg in enumerate(configs):
            rec = self._rows.get(config_key(spec, cfg, app))
            if rec is not None:
                objs[i] = (rec["behav"], rec["ppa"])
                hit[i] = True
        tel = self.tel
        n_hit = int(hit.sum())
        if n_hit:
            tel.count("service.store_hit", n_hit)
        if D - n_hit:
            tel.count("service.store_miss", D - n_hit)
        return objs, hit

    def put_rows(self, spec, configs: np.ndarray, objs: np.ndarray,
                 app: str | None = None) -> int:
        """Persist characterized rows; returns how many were new."""
        self._load()
        fresh: list[dict] = []
        for cfg, (b, p) in zip(configs, np.asarray(objs, np.float64)):
            key = config_key(spec, cfg, app)
            if key in self._rows:
                continue
            rec = {
                "schema": SCHEMA_VERSION,
                "key": key,
                "spec": spec.tag,
                "app": app,
                "config": _bits(cfg),
                "behav": float(b),
                "ppa": float(p),
            }
            self._rows[key] = rec
            fresh.append(rec)
        self._append(_ROWS_SHARD, fresh)
        self._gauge_sizes()
        return len(fresh)

    def cached_characterize(self, spec, fn, app: str | None = None):
        """Wrap a ``configs -> (D, 2)`` objective fn with library dedup.

        Known configs are answered from the store (no fastchar dispatch);
        misses go through ``fn`` in one batch and are persisted.  With an
        empty library every config misses and the wrapped fn is an exact
        pass-through -- the bit-identity guarantee for cold starts.
        """

        def wrapped(configs: np.ndarray) -> np.ndarray:
            if len(configs) == 0:
                return fn(configs)
            objs, hit = self.lookup_rows(spec, configs, app)
            if hit.all():
                return objs
            miss = ~hit
            computed = np.asarray(fn(np.asarray(configs)[miss]), np.float64)
            objs[miss] = computed
            self.put_rows(spec, np.asarray(configs)[miss], computed, app)
            return objs

        return wrapped

    # -- validated fronts + request cache -------------------------------------

    def put_front(
        self, spec, app: str | None, const_sf: float, seed: int, method: str,
        vpf_configs: np.ndarray, vpf_objs: np.ndarray, hv_vpf: float,
        ppf_configs: np.ndarray | None = None,
        ppf_objs: np.ndarray | None = None, hv_ppf: float = 0.0,
        n_evals: int = 0, request: str | None = None,
    ) -> dict:
        """Persist one validated front (and optionally its request digest)."""
        self._load()
        rec = {
            "schema": SCHEMA_VERSION,
            "key": _digest({
                "schema": SCHEMA_VERSION, "kind": "front", "spec": spec.tag,
                "app": app, "const_sf": round(float(const_sf), 9),
                "seed": int(seed), "method": method,
                "configs": [_bits(c) for c in vpf_configs],
            }),
            "spec": spec.tag,
            "app": app,
            "const_sf": float(const_sf),
            "seed": int(seed),
            "method": method,
            "configs": [_bits(c) for c in vpf_configs],
            "objs": np.asarray(vpf_objs, np.float64).tolist(),
            "hv": float(hv_vpf),
            "ppf_configs": [_bits(c) for c in ppf_configs]
            if ppf_configs is not None else [],
            "ppf_objs": np.asarray(ppf_objs, np.float64).tolist()
            if ppf_objs is not None else [],
            "hv_ppf": float(hv_ppf),
            "n_evals": int(n_evals),
            "request": request,
        }
        self._fronts.append(rec)
        if request:
            self._requests[request] = rec
        self._append(_FRONTS_SHARD, [rec])
        self._gauge_sizes()
        return rec

    def lookup_result(self, request: str) -> dict | None:
        """Full-request cache: the front record previously stored under this
        request digest, or None."""
        self._load()
        rec = self._requests.get(request)
        tel = self.tel
        tel.count("service.request_hit" if rec is not None
                  else "service.request_miss")
        return rec

    def fronts(self, spec=None, app: str | None = "*") -> list[dict]:
        """Stored front records, optionally filtered by spec tag / app name."""
        self._load()
        out = list(self._fronts)
        if spec is not None:
            out = [r for r in out if r["spec"] == spec.tag]
        if app != "*":
            out = [r for r in out if r["app"] == app]
        return out

    def nearest_fronts(self, spec, app: str | None, const_sf: float,
                       k: int = 3) -> list[dict]:
        """The k cached fronts nearest to (spec, app, const_sf).

        Same spec tag is mandatory; distance is (app mismatch, |const_sf
        delta|) lexicographic, recency breaking ties -- an exact-app front at
        a nearby constraint beats a cross-app front at the exact constraint.
        """
        cand = self.fronts(spec)
        cand = [r for r in cand if r["configs"]]
        cand.sort(key=lambda r: (r["app"] != app,
                                 abs(r["const_sf"] - float(const_sf))))
        return cand[:k]

    def warm_pool(self, spec, app: str | None, const_sf: float,
                  limit: int = 64, k: int = 3) -> np.ndarray | None:
        """Union of the nearest cached fronts' configs: the GA seed pool.

        Returns None when the library holds nothing relevant (the cold-start
        path stays bit-identical).  Deduplicates preserving nearest-first
        order and caps at ``limit`` members.
        """
        seen: set[str] = set()
        rows: list[np.ndarray] = []
        for rec in self.nearest_fronts(spec, app, const_sf, k=k):
            for bits in rec["configs"]:
                if bits in seen or len(rows) >= limit:
                    continue
                seen.add(bits)
                rows.append(_unbits(bits))
        if not rows:
            return None
        return np.stack(rows).astype(np.uint8)

    # -- seeding + status -----------------------------------------------------

    def seed_fixed_library(self, spec, settings=None, app=None) -> int:
        """Characterize the frozen EvoApprox-style corpus into the store.

        Uses :func:`repro_torch.core.dse.fixed_library` (design members independent
        of any DSE problem) and the default operator-level characterization;
        returns how many rows were newly persisted.
        """
        from ..core.dse import DSESettings, _default_characterize, fixed_library

        settings = settings or DSESettings()
        configs = fixed_library(spec)
        app_name = getattr(app, "name", app)
        _, hit = self.lookup_rows(spec, configs, app_name)
        if hit.all():
            return 0
        fn = (app.characterize_fn(spec, ppa_key=settings.ppa_key,
                                  backend=settings.context)
              if app is not None
              else _default_characterize(spec, settings))
        miss = ~hit
        objs = np.asarray(fn(configs[miss]), np.float64)
        return self.put_rows(spec, configs[miss], objs, app_name)

    def stats(self) -> dict:
        self._load()
        return {
            "root": self.root,
            "rows": len(self._rows),
            "fronts": len(self._fronts),
            "requests": len(self._requests),
            "specs": sorted({r["spec"] for r in self._rows.values()}
                            | {r["spec"] for r in self._fronts}),
        }


def store_status(store: OperatorStore | None = None) -> dict:
    """Health snapshot of the operator library (``/healthz`` payload).

    Never raises: a corrupt/unreadable library reads as empty (the same
    recovery the loader applies) and the traffic counters come from the
    process-wide aggregate.
    """
    try:
        store = store or OperatorStore()
        st = store.stats()
    except Exception as exc:  # pragma: no cover - defensive
        return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    st.update({
        "ok": True,
        "hits": obs.GLOBAL.counter("service.store_hit"),
        "misses": obs.GLOBAL.counter("service.store_miss"),
        "request_hits": obs.GLOBAL.counter("service.request_hit"),
        "request_misses": obs.GLOBAL.counter("service.request_miss"),
        "corrupt": obs.GLOBAL.counter("service.store_corrupt"),
    })
    return st
