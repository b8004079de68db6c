"""Carry DSE state across as plain numpy arrays and dicts.

A characterized ``Dataset``, fitted estimators (``PolyRegModel``,
``GBTRegressor``, ``AutoMLRegressor``) and MaP problem batteries
(``MapProblem``) are plain numeric state.  :func:`state_of` reads that state
off any object with the same attributes -- the port's own or another
implementation's -- into dicts of numpy arrays and Python scalars, and
:func:`from_state` builds the port's object from such a dict, so two
implementations can compute from the same fitted state.  Only attributes are
read: nothing is imported from elsewhere.

An application (``repro_torch.apps``) is carried as its name, its dataclass
fields and the arrays its data generators made (:data:`APP_ARRAYS`), so two
implementations score the same data.

An AxO operator (``axo.AxOOperator``) is carried as its arrays, kind
``axo_operator``.  Model parameters are nested dicts of arrays:
:func:`params_from_jax` maps such a tree, as numpy arrays of the reference's
``init_params`` tree, onto the port's tensors by name, leaf for leaf, with
the stacked ``(repeats, ...)`` leaves kept stacked as the port's model uses
them.

State dicts carry a ``"kind"`` tag: ``dataset``, ``poly``, ``gbt``,
``automl``, ``quad_expr``, ``map_problem``, ``app`` or ``axo_operator``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .apps import APPLICATIONS
from .axo.deploy import AxOOperator
from .core.engine import ExecutionContext
from .core.automl import AutoMLRegressor
from .core.dataset import Dataset
from .core.gbt import GBTRegressor, _Tree
from .core.miqcp import MapProblem, QuadExpr
from .core.regression import MinMaxScaler, PolyRegModel
from .models.model import model_spec
from .models.spec import _leaf_paths

__all__ = ["state_of", "from_state", "params_from_jax"]

_GBT_PARAMS = ("n_trees", "max_depth", "learning_rate", "subsample", "min_leaf", "seed")
_AXO_ARRAYS = ("f_table", "g_table", "signed_vals", "table")
# the generated data of each application, by app name
APP_ARRAYS = {
    "mnist": ("_xte", "_W", "_labels"),
    "ffn": ("_x", "_w1", "_w2"),
    "ecg": ("_sig", "_taps"),
    "gauss": ("_img", "_kern", "_float_ref"),
}


def _arr(x, dtype=None) -> np.ndarray:
    return np.array(x, dtype=dtype, copy=True)


def state_of(obj) -> dict:
    """Plain-array state of a dataset, estimator, MaP problem or app (duck-typed)."""
    if hasattr(obj, "behav_from_tables") and getattr(obj, "name", None) in APP_ARRAYS:
        return {
            "kind": "app",
            "name": obj.name,
            "fields": {f.name: getattr(obj, f.name)
                       for f in dataclasses.fields(obj) if f.init},
            "arrays": {k: _arr(getattr(obj, k)) for k in APP_ARRAYS[obj.name]},
        }
    if hasattr(obj, "f_table") and hasattr(obj, "rank_table"):
        return {
            "kind": "axo_operator",
            "n_bits": int(obj.n_bits),
            "rank": int(obj.rank),
            **{k: _arr(getattr(obj, k)) for k in _AXO_ARRAYS},
        }
    if hasattr(obj, "configs") and hasattr(obj, "metrics"):
        return {
            "kind": "dataset",
            "configs": _arr(obj.configs, np.uint8),
            "metrics": {k: _arr(v, np.float64) for k, v in obj.metrics.items()},
            "source": _arr(obj.source, np.uint8),
        }
    if hasattr(obj, "trees") and hasattr(obj, "learning_rate"):
        return {
            "kind": "gbt",
            **{k: getattr(obj, k) for k in _GBT_PARAMS},
            "base": float(obj.base),
            "trees": [
                {a: _arr(getattr(t, a)) for a in ("feature", "left", "right", "value")}
                for t in obj.trees
            ],
        }
    if hasattr(obj, "quad_pairs") and hasattr(obj, "scaler"):
        return {
            "kind": "poly",
            "n_features": int(obj.n_features),
            "quad_pairs": [(int(i), int(j)) for i, j in obj.quad_pairs],
            "intercept": float(obj.intercept),
            "linear": _arr(obj.linear, np.float64),
            "quad": _arr(obj.quad, np.float64),
            "scaler": (float(obj.scaler.lo), float(obj.scaler.hi)),
        }
    if hasattr(obj, "model") and hasattr(obj, "n_quad"):
        return {
            "kind": "automl",
            "n_quad": int(obj.n_quad),
            "seed": int(obj.seed),
            "name": str(obj.name),
            "model": state_of(obj.model),
        }
    if hasattr(obj, "lin") and hasattr(obj, "quad") and hasattr(obj, "const"):
        return {
            "kind": "quad_expr",
            "const": float(obj.const),
            "lin": _arr(obj.lin, np.float64),
            "quad": _arr(obj.quad, np.float64),
        }
    if hasattr(obj, "obj") and hasattr(obj, "max_behav"):
        return {
            "kind": "map_problem",
            "obj": state_of(obj.obj),
            "behav": state_of(obj.behav),
            "ppa": state_of(obj.ppa),
            **{k: float(getattr(obj, k))
               for k in ("max_behav", "max_ppa", "wt_b", "const_sf")},
            "n_quad": int(obj.n_quad),
            "meta": dict(obj.meta),
        }
    raise TypeError(f"no state mapping for {type(obj).__name__}")


def from_state(state: dict):
    """The port's object for a :func:`state_of` dict."""
    kind = state["kind"]
    if kind == "dataset":
        return Dataset(
            configs=_arr(state["configs"], np.uint8),
            metrics={k: _arr(v, np.float64) for k, v in state["metrics"].items()},
            source=_arr(state["source"], np.uint8),
        )
    if kind == "poly":
        lo, hi = state["scaler"]
        return PolyRegModel(
            n_features=state["n_features"],
            quad_pairs=list(state["quad_pairs"]),
            intercept=state["intercept"],
            linear=_arr(state["linear"], np.float64),
            quad=_arr(state["quad"], np.float64),
            scaler=MinMaxScaler(lo, hi),
        )
    if kind == "gbt":
        model = GBTRegressor(**{k: state[k] for k in _GBT_PARAMS})
        model.base = state["base"]
        model.trees = [
            _Tree(
                feature=_arr(t["feature"], np.int64),
                left=_arr(t["left"], np.int64),
                right=_arr(t["right"], np.int64),
                value=_arr(t["value"], np.float64),
            )
            for t in state["trees"]
        ]
        return model
    if kind == "automl":
        est = AutoMLRegressor(n_quad=state["n_quad"], seed=state["seed"])
        est.model = from_state(state["model"])
        est.name = state["name"]
        return est
    if kind == "quad_expr":
        return QuadExpr(
            const=state["const"],
            lin=_arr(state["lin"], np.float64),
            quad=_arr(state["quad"], np.float64),
        )
    if kind == "map_problem":
        return MapProblem(
            obj=from_state(state["obj"]),
            behav=from_state(state["behav"]),
            ppa=from_state(state["ppa"]),
            max_behav=state["max_behav"],
            max_ppa=state["max_ppa"],
            wt_b=state["wt_b"],
            const_sf=state["const_sf"],
            n_quad=state["n_quad"],
            meta=dict(state["meta"]),
        )
    if kind == "app":
        app = APPLICATIONS[state["name"]](**state["fields"])
        for k, v in state["arrays"].items():
            setattr(app, k, _arr(v))
        n_bits = app._prep_bits
        app._prep_bits = 0   # requantize the carried arrays (drops references)
        app._prepare(n_bits)
        return app
    if kind == "axo_operator":
        return AxOOperator(n_bits=state["n_bits"], rank=state["rank"],
                           **{k: _arr(state[k]) for k in _AXO_ARRAYS})
    raise ValueError(f"unknown state kind {kind!r}")


def _tensor(x, device, dtype) -> torch.Tensor:
    """A numpy (or array-like) leaf as a tensor; bfloat16 arrays pass through f32."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def params_from_jax(tree: dict, cfg=None, *, device=None, dtype=None) -> dict:
    """The reference's parameter tree (numpy leaves) as the port's tensors.

    Leaves map by name: ``tree["stages"]["0"]["0"]["mixer"]["wq"]`` becomes the
    port's leaf of the same path, stacked layers staying stacked.  With ``cfg``
    the tree must hold exactly the leaves of ``model_spec(cfg)``, each of its
    shape.  ``device`` defaults to the card; ``dtype`` keeps each leaf's own
    unless given.
    """
    dev = ExecutionContext(device=device).device
    if cfg is not None:
        want = {path: tuple(s.shape) for path, s in _leaf_paths(model_spec(cfg))}
        got = {path: tuple(np.shape(x)) for path, x in _leaf_paths(tree)}
        if want.keys() != got.keys():
            raise ValueError(f"parameter trees differ: missing {sorted(want.keys() - got)}, "
                             f"extra {sorted(got.keys() - want)}")
        bad = {p: (got[p], want[p]) for p in want if got[p] != want[p]}
        if bad:
            raise ValueError(f"leaf shapes differ (got, want): {bad}")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _tensor(t, dev, dtype)

    return walk(tree)
