"""Observed-data ingestion: station/arrival tables from HDF5 and CSV
(SURVEY.md §1 L5 "dataset loaders (synthetic generators + station/arrival
tables)"; the reference family reads station/arrival tables from HDF5 —
see model/data.py).

Two on-disk forms:

- **HDF5** (self-describing, written by :func:`save_dataset_hdf5`):
  root attrs ``kind`` in {"tomo", "events"}; datasets per kind
  (tomo: ``src_xyz``/``rec_xyz``/``t_obs``[/``mask``];
  events: ``sta_xyz``/``t_obs``[/``mask``]), plus an optional
  ``slowness`` field with grid attrs — a truth model for validation or
  the fixed heterogeneous model for locate mode.
- **CSV** station + arrival tables (the classic seismology exchange
  form): ``stations.csv`` with header ``station,x,y[,z]`` and
  ``arrivals.csv`` with header ``event,station,time``. Missing
  (event, station) pairs become mask=0 entries, so ragged pick sets are
  handled exactly like the reference's masked residuals.

Everything loads to device-resident pytrees (model/data.py) consumed by
the posterior closure; files are only touched at build time, never in
the hot loop.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Tuple

import numpy as np

from mceik_tpu.grid import Grid
from mceik_tpu.model.data import EventData, TomoData


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------

def require_h5py():
    """Import h5py on first use: only users' HDF5 files need it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing HDF5 files needs the h5py "
                          "package, which is not installed") from e
    return h5py


def save_dataset_hdf5(path: str, data, slowness: Optional[np.ndarray] = None,
                      grid: Optional[Grid] = None,
                      extra: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Write a TomoData/EventData (+ optional slowness model) atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    h5py = require_h5py()

    with h5py.File(tmp, "w") as f:
        if isinstance(data, TomoData):
            f.attrs["kind"] = "tomo"
            f.create_dataset("src_xyz", data=np.asarray(data.src_xyz, np.float32))
            f.create_dataset("rec_xyz", data=np.asarray(data.rec_xyz, np.float32))
        elif isinstance(data, EventData):
            f.attrs["kind"] = "events"
            f.create_dataset("sta_xyz", data=np.asarray(data.sta_xyz, np.float32))
        else:
            raise TypeError(f"unsupported dataset type {type(data).__name__}")
        f.create_dataset("t_obs", data=np.asarray(data.t_obs, np.float32))
        if data.mask is not None:
            f.create_dataset("mask", data=np.asarray(data.mask, np.float32))
        if slowness is not None:
            ds = f.create_dataset("slowness", data=np.asarray(slowness, np.float32))
            if grid is not None:
                ds.attrs["spacing"] = np.asarray(grid.spacing, np.float64)
                ds.attrs["origin"] = np.asarray(grid.origin, np.float64)
        for k, v in (extra or {}).items():
            f.create_dataset(k, data=np.asarray(v))
    os.replace(tmp, path)


def load_dataset_hdf5(path: str) -> Tuple[object, Dict[str, np.ndarray]]:
    """Load (data, truth_dict). truth_dict carries the stored slowness
    model (and any hypo/t0 extras) when present."""
    import jax.numpy as jnp

    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        kind = f.attrs.get("kind")
        t_obs = jnp.asarray(np.asarray(f["t_obs"]), jnp.float32)
        mask = (jnp.asarray(np.asarray(f["mask"]), jnp.float32)
                if "mask" in f else None)
        truth: Dict[str, np.ndarray] = {}
        for k in ("slowness", "hypo", "t0"):
            if k in f:
                truth[k] = np.asarray(f[k])
        if kind == "tomo":
            data = TomoData(
                src_xyz=jnp.asarray(np.asarray(f["src_xyz"]), jnp.float32),
                rec_xyz=jnp.asarray(np.asarray(f["rec_xyz"]), jnp.float32),
                t_obs=t_obs, mask=mask)
        elif kind == "events":
            data = EventData(
                sta_xyz=jnp.asarray(np.asarray(f["sta_xyz"]), jnp.float32),
                t_obs=t_obs, mask=mask)
        else:
            raise ValueError(
                f"{path}: missing/unknown 'kind' attr {kind!r} "
                "(expected 'tomo' or 'events')")
    return data, truth


def save_slowness_hdf5(path: str, slowness: np.ndarray, grid: Grid) -> None:
    """Standalone slowness-model file (locate mode's fixed velocity model)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    h5py = require_h5py()

    with h5py.File(tmp, "w") as f:
        ds = f.create_dataset("slowness", data=np.asarray(slowness, np.float32))
        ds.attrs["spacing"] = np.asarray(grid.spacing, np.float64)
        ds.attrs["origin"] = np.asarray(grid.origin, np.float64)
    os.replace(tmp, path)


def load_slowness_hdf5(path: str, expect_grid: Optional[Grid] = None
                       ) -> np.ndarray:
    """Load a slowness field; validates geometry against ``expect_grid``."""
    h5py = require_h5py()

    with h5py.File(path, "r") as f:
        ds = f["slowness"]
        s = np.asarray(ds, np.float32)
        if expect_grid is not None:
            if tuple(s.shape) != tuple(expect_grid.shape):
                raise ValueError(
                    f"{path}: slowness shape {s.shape} != grid "
                    f"{tuple(expect_grid.shape)}")
            sp = ds.attrs.get("spacing")
            if sp is not None and not np.allclose(sp, expect_grid.spacing):
                raise ValueError(
                    f"{path}: slowness spacing {sp} != grid "
                    f"{expect_grid.spacing}")
    return s


# ---------------------------------------------------------------------------
# CSV station/arrival tables
# ---------------------------------------------------------------------------

def load_stations_csv(path: str) -> Tuple[list, np.ndarray]:
    """``station,x,y[,z]`` -> (names, xyz(n_sta, D)); order = file order."""
    names, rows = [], []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols = [c for c in ("x", "y", "z") if c in reader.fieldnames]
        if "station" not in reader.fieldnames or len(cols) < 2:
            raise ValueError(
                f"{path}: need header 'station,x,y[,z]', got "
                f"{reader.fieldnames}")
        for row in reader:
            names.append(row["station"])
            rows.append([float(row[c]) for c in cols])
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate station names")
    return names, np.asarray(rows, np.float32)


def load_arrivals_csv(path: str, station_names: list
                      ) -> Tuple[list, np.ndarray, np.ndarray]:
    """``event,station,time`` -> (event_ids, t_obs(n_ev, n_sta), mask).

    Events ordered by first appearance; stations resolved against
    ``station_names``; missing picks get mask=0 (t_obs entry 0.0, never
    read through the masked likelihood).
    """
    sta_index = {s: j for j, s in enumerate(station_names)}
    events: list = []
    ev_index: Dict[str, int] = {}
    picks = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        need = {"event", "station", "time"}
        if not need.issubset(set(reader.fieldnames or ())):
            raise ValueError(
                f"{path}: need header 'event,station,time', got "
                f"{reader.fieldnames}")
        for row in reader:
            ev = row["event"]
            sta = row["station"]
            if sta not in sta_index:
                raise ValueError(f"{path}: unknown station {sta!r}")
            if ev not in ev_index:
                ev_index[ev] = len(events)
                events.append(ev)
            picks.append((ev_index[ev], sta_index[sta], float(row["time"])))
    n_ev, n_sta = len(events), len(station_names)
    t_obs = np.zeros((n_ev, n_sta), np.float32)
    mask = np.zeros((n_ev, n_sta), np.float32)
    for i, j, t in picks:
        if mask[i, j]:
            raise ValueError(
                f"{path}: duplicate pick for event {events[i]!r} / "
                f"station {station_names[j]!r}")
        t_obs[i, j] = t
        mask[i, j] = 1.0
    return events, t_obs, mask


def load_events_csv(stations_path: str, arrivals_path: str) -> EventData:
    """Station + arrival CSV tables -> EventData (masked)."""
    import jax.numpy as jnp

    names, sta_xyz = load_stations_csv(stations_path)
    _, t_obs, mask = load_arrivals_csv(arrivals_path, names)
    return EventData(sta_xyz=jnp.asarray(sta_xyz),
                     t_obs=jnp.asarray(t_obs),
                     mask=jnp.asarray(mask))


def save_events_csv(stations_path: str, arrivals_path: str,
                    data: EventData) -> None:
    """Write EventData out as the CSV pair (round-trip of load_events_csv)."""
    sta = np.asarray(data.sta_xyz)
    t_obs = np.asarray(data.t_obs)
    mask = (np.asarray(data.mask) if data.mask is not None
            else np.ones_like(t_obs))
    cols = ["x", "y", "z"][:sta.shape[1]]
    with open(stations_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["station"] + cols)
        for j in range(sta.shape[0]):
            w.writerow([f"STA{j:03d}"] + [repr(float(v)) for v in sta[j]])
    with open(arrivals_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["event", "station", "time"])
        for i in range(t_obs.shape[0]):
            for j in range(t_obs.shape[1]):
                if mask[i, j]:
                    w.writerow([f"EV{i:04d}", f"STA{j:03d}",
                                repr(float(t_obs[i, j]))])
