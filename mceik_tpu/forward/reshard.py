"""Station-axis resharding of traveltime tables (SURVEY.md §2.3 "Ulysses
(all-to-all head shard)" analog; §5 likelihood-gather note).

When tables are GRID-sharded (domain-decomposed solves, eikonal/dist_sweep
— each device holds a slab of every station's field), the receiver-interp
gather needs values from whichever device owns the slab containing each
event. Rather than gathering scattered points across slabs, one
``all_to_all`` re-shards the tables from

    (S, X/n, Y, Z)  per device   [grid-sharded, stations replicated]
to
    (S/n, X, Y, Z)  per device   [station-sharded, grid replicated]

— the exact transposition Ulysses does between sequence-sharded and
head-sharded attention. Each device then interpolates its OWN stations'
full fields locally; the resulting ``(S/n, E)`` arrival matrix is tiny and
is re-assembled with one ``all_gather``. Total comms: one all-to-all of
the table bytes (the minimum possible data motion — every table value
changes owner at most once) + one small all-gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mceik_tpu.grid import Grid


def reshard_tables_to_stations(tables: jnp.ndarray, mesh: Mesh,
                               axis_name: str = "grid") -> jnp.ndarray:
    """All-to-all: grid-sharded ``(S,) + grid.shape`` tables -> station-
    sharded. Station count must divide the mesh axis size."""
    n_dev = mesh.shape[axis_name]
    S = tables.shape[0]
    if S % n_dev != 0:
        raise ValueError(f"n_stations ({S}) must divide over {n_dev} devices")

    @partial(jax.shard_map, mesh=mesh,
             in_specs=P(None, axis_name),
             out_specs=P(axis_name))
    def a2a(local):  # local: (S, X/n, Y, Z)
        # split stations over devices, concatenate grid slabs back together.
        return lax.all_to_all(local, axis_name, split_axis=0, concat_axis=1,
                              tiled=True)

    return a2a(tables)


def predict_events_resharded(
    tables: jnp.ndarray,
    event_xyz: jnp.ndarray,
    t0: jnp.ndarray,
    grid: Grid,
    mesh: Mesh,
    axis_name: str = "grid",
) -> jnp.ndarray:
    """Predicted arrivals ``(n_ev, n_sta)`` from grid-sharded station
    tables: Ulysses-style reshard, local full-field interpolation of each
    device's stations, small all-gather of the per-station rows."""
    from mceik_tpu.forward.predict import interp_at

    S = tables.shape[0]
    tables_s = reshard_tables_to_stations(tables, mesh, axis_name)

    # check_vma=False: the all_gather provably replicates the output, but
    # shard_map's static replication checker cannot see that.
    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis_name), P(), P()),
             out_specs=P(), check_vma=False)
    def gather(tabs_local, ev, t0_):  # tabs_local: (S/n,) + grid.shape
        tt_local = jax.vmap(lambda T: interp_at(T, ev, grid))(tabs_local)
        tt = lax.all_gather(tt_local, axis_name, axis=0, tiled=True)  # (S, E)
        return tt.T + t0_[:, None]

    return gather(tables_s, event_xyz, t0)
