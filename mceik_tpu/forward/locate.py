"""Hypocenter grid search over precomputed station tables (SURVEY.md §2.1
"Hypocenter grid-search / locate mode", §3.5).

For each event, evaluates the origin-time-marginalized Gaussian misfit at
EVERY grid node simultaneously (the traveltime tables already hold T from
each station to every node — reciprocity) and takes the argmax. Trivially
parallel: one (n_sta, n_nodes) reduction per event. Used to
initialize sampler chains near the likelihood mode and as the standalone
locate tool.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.grid import Grid


def locate_grid_search(station_tables: jnp.ndarray, t_obs: jnp.ndarray,
                       grid: Grid, sigma: float = 1.0,
                       mask: jnp.ndarray = None):
    """Maximum-likelihood hypocenters on the grid.

    Args:
      station_tables: ``(n_sta,) + grid.shape`` traveltime fields.
      t_obs: ``(n_ev, n_sta)`` observed arrivals.
      mask: optional ``(n_ev, n_sta)`` observation mask.

    Returns dict with ``hypo`` (n_ev, D) physical coords, ``t0`` (n_ev,)
    origin-time estimates, and ``loglik`` (n_ev,) at the optimum.
    """
    n_sta = station_tables.shape[0]
    Tt = station_tables.reshape(n_sta, -1)  # (n_sta, n_nodes)

    def per_event(tobs_e, mask_e):
        # Origin time marginalized analytically: t0* = mean(t_obs - T).
        r = tobs_e[:, None] - Tt                       # (n_sta, n_nodes)
        w = mask_e[:, None]
        n = jnp.maximum(jnp.sum(mask_e), 1.0)
        t0 = jnp.sum(w * r, axis=0) / n                # (n_nodes,)
        resid = (r - t0[None, :]) * w
        sse = jnp.sum(resid * resid, axis=0)
        node = jnp.argmin(sse)
        ll = -0.5 * sse[node] / (sigma * sigma)
        return node, t0[node], ll

    if mask is None:
        mask = jnp.ones_like(t_obs)
    nodes, t0s, lls = jax.vmap(per_event)(t_obs, mask)

    idx = jnp.stack(jnp.unravel_index(nodes, grid.shape), axis=-1)
    hypo = grid.to_physical_coords(idx.astype(jnp.float32))
    return {"hypo": hypo, "t0": t0s, "loglik": lls}
