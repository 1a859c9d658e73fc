"""Host-side HDF5 cache of station traveltime tables (SURVEY.md §2.1
"Traveltime tables": in-memory batched solves are the hot path; the disk
cache serves locate-only workflows that reuse one velocity model across
many event batches, replacing the reference's HDF5 table files).

The cache key hashes the grid geometry, solver config, station coords and
the slowness field, so a stale model can never serve wrong tables.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from mceik_tpu.eikonal.solve import EikonalConfig
from mceik_tpu.grid import Grid


def _table_key(slowness, sta_xyz, grid: Grid, config: EikonalConfig) -> str:
    h = hashlib.sha256()
    h.update(repr((grid.shape, grid.spacing, grid.origin)).encode())
    h.update(repr((config.method, config.tol, config.max_iters,
                   config.n_inner, config.seed_radius)).encode())
    h.update(np.ascontiguousarray(np.asarray(sta_xyz, np.float32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(slowness, np.float32)).tobytes())
    return h.hexdigest()[:16]


def cached_traveltime_tables(slowness, sta_xyz, grid: Grid,
                             config: EikonalConfig = EikonalConfig(),
                             cache_dir: Optional[str] = None):
    """Compute (or load) per-station traveltime tables.

    With ``cache_dir`` set, tables are stored under a content-addressed
    filename and reloaded on subsequent calls (atomic write-rename).
    Returns a host numpy array ``(n_sta,) + grid.shape``.
    """
    from mceik_tpu.forward.predict import traveltime_tables

    if cache_dir is None:
        return np.asarray(traveltime_tables(slowness, sta_xyz, grid, config))

    from mceik_tpu.io.loaders import require_h5py

    h5py = require_h5py()
    key = _table_key(slowness, sta_xyz, grid, config)
    path = os.path.join(cache_dir, f"tables_{key}.h5")
    if os.path.exists(path):
        with h5py.File(path, "r") as f:
            return np.asarray(f["tables"])

    tables = np.asarray(traveltime_tables(slowness, sta_xyz, grid, config))
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + ".tmp"
    with h5py.File(tmp, "w") as f:
        f.create_dataset("tables", data=tables)
        f.attrs["key"] = key
        f.attrs["n_sta"] = tables.shape[0]
    os.replace(tmp, path)
    return tables
