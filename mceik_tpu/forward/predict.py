"""Traveltime tables + receiver interpolation -> predicted arrivals.

Key structural choice (differs from a naive port): hypocenter gradients
never re-run the solver. Tables are solved *from the stations* (reciprocity
of first-arrival traveltimes), so ``t_pred(event) = T_station(event_pos) +
t0`` and d(t_pred)/d(hypocenter) flows through trilinear interpolation only
(SURVEY.md §3.3, §3.5). Slowness gradients flow through the solver via the
implicit adjoint (eikonal/adjoint.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mceik_tpu.eikonal.solve import EikonalConfig, solve_eikonal
from mceik_tpu.grid import Grid


def traveltime_tables(
    slowness: jnp.ndarray,
    table_xyz: jnp.ndarray,
    grid: Grid,
    config: EikonalConfig = EikonalConfig(),
    differentiable: bool = False,
) -> jnp.ndarray:
    """Solve one traveltime field per table point (station or source).

    Args:
      slowness: grid-shaped slowness field.
      table_xyz: ``(n_tab, D)`` physical coordinates of the solve origins.
      differentiable: route through the implicit-adjoint solver so that
        gradients w.r.t. ``slowness`` are available (HMC/NUTS paths).

    Returns: ``(n_tab,) + grid.shape`` traveltime fields.
    """
    # Every batched solve goes through the flat-batch custom_vmap boundary
    # (eikonal/batched.py): outer vmaps (chains, events) merge into one
    # rank-1 batch, which the GPU kernel runs in one launch.
    if differentiable:
        from mceik_tpu.eikonal.adjoint import solve_eikonal_diff_batched

        return solve_eikonal_diff_batched(slowness, table_xyz, grid, config)

    from mceik_tpu.eikonal.batched import solve_eikonal_batched

    return solve_eikonal_batched(slowness, table_xyz, grid, config)


def interp_at(T: jnp.ndarray, xyz: jnp.ndarray, grid: Grid) -> jnp.ndarray:
    """Multilinear interpolation of one grid field at physical points.

    ``T``: grid-shaped field; ``xyz``: ``(..., D)``. Returns ``(...,)``.
    """
    idx = grid.to_index_coords(xyz)
    coords = [idx[..., d] for d in range(grid.ndim)]
    return jax.scipy.ndimage.map_coordinates(T, coords, order=1, mode="nearest")


def interp_tables(tables: jnp.ndarray, xyz: jnp.ndarray, grid: Grid) -> jnp.ndarray:
    """Interpolate each table at each point: ``(n_tab, ...pts)``."""
    return jax.vmap(lambda T: interp_at(T, xyz, grid))(tables)


def predict_tomo(
    slowness: jnp.ndarray,
    src_xyz: jnp.ndarray,
    rec_xyz: jnp.ndarray,
    grid: Grid,
    config: EikonalConfig = EikonalConfig(),
    solve_from: str = "auto",
    differentiable: bool = False,
) -> jnp.ndarray:
    """Predicted traveltimes for known source/receiver pairs.

    Returns ``t_pred`` of shape ``(n_src, n_rec)``. Solves from whichever
    side has fewer points (reciprocity) unless forced by ``solve_from``.
    """
    n_src, n_rec = src_xyz.shape[0], rec_xyz.shape[0]
    if solve_from == "auto":
        solve_from = "src" if n_src <= n_rec else "rec"
    if solve_from == "src":
        tables = traveltime_tables(slowness, src_xyz, grid, config, differentiable)
        return interp_tables(tables, rec_xyz, grid)  # (n_src, n_rec)
    tables = traveltime_tables(slowness, rec_xyz, grid, config, differentiable)
    return interp_tables(tables, src_xyz, grid).T  # (n_rec, n_src) -> (n_src, n_rec)


def predict_events(
    station_tables: jnp.ndarray,
    event_xyz: jnp.ndarray,
    t0: jnp.ndarray,
    grid: Grid,
) -> jnp.ndarray:
    """Predicted arrivals for events with unknown hypocenters.

    Args:
      station_tables: ``(n_sta,) + grid.shape`` traveltime fields solved
        from each station (reciprocity).
      event_xyz: ``(n_ev, D)`` hypocenters. t0: ``(n_ev,)`` origin times.

    Returns ``(n_ev, n_sta)`` predicted arrival times.
    """
    tt = interp_tables(station_tables, event_xyz, grid)  # (n_sta, n_ev)
    return tt.T + t0[:, None]
