"""Observed-data containers (device-resident pytrees).

The reference reads station/arrival tables from HDF5 (SURVEY.md §1 L5);
here data arrives as plain arrays in small pytree dataclasses that the
posterior closure captures, so the whole likelihood is jit-traceable.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from mceik_tpu.utils import pytree_dataclass


@pytree_dataclass
class TomoData:
    """Known source/receiver pairs (configs 1-2)."""

    src_xyz: jnp.ndarray  # (n_src, D)
    rec_xyz: jnp.ndarray  # (n_rec, D)
    t_obs: jnp.ndarray    # (n_src, n_rec)
    mask: Optional[jnp.ndarray] = None  # (n_src, n_rec) 1.0 = observed


@pytree_dataclass
class EventData:
    """Stations + events with unknown hypocenters (configs 3/5)."""

    sta_xyz: jnp.ndarray  # (n_sta, D)
    t_obs: jnp.ndarray    # (n_ev, n_sta)
    mask: Optional[jnp.ndarray] = None  # (n_ev, n_sta)
