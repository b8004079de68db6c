"""repro_torch.service -- persistent DSE service layer (counterpart of
``repro.service``).

The operator library (:mod:`.store`) is a content-addressed, on-disk store of
characterized BEHAV/PPA rows and validated fronts: ``hash(config, spec, app,
const_sf)`` keys schema-versioned JSONL shards under ``experiments/library/``
(env-overridable via ``REPRO_OPERATOR_LIBRARY``).  Known configs skip the
fastchar dispatch entirely, repeated requests return their cached front, and
new sweeps warm-start the GA from the library's nearest cached fronts.

The job queue (:mod:`.queue`) coalesces compatible pending (spec, app,
const_sf, seed) DSE requests into single ``run_dse_sweep`` lane dispatches,
amortizing characterization cost across requests.  It backs the
``POST /dse`` endpoint on ``repro_torch.launch.serve``.
"""

from .store import (
    SCHEMA_VERSION,
    OperatorStore,
    config_key,
    library_dir,
    request_key,
    store_status,
)
from .queue import DSEJobQueue, DSERequest, default_runner

__all__ = [
    "SCHEMA_VERSION",
    "OperatorStore",
    "config_key",
    "library_dir",
    "request_key",
    "store_status",
    "DSEJobQueue",
    "DSERequest",
    "default_runner",
]
