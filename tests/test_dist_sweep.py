"""Grid-sharded (domain-decomposed) solve vs single-device reference on
the 8-virtual-device CPU mesh (SURVEY.md §4 "Distributed (no cluster)",
§2.3 SP/CP analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.dist.mesh import chain_mesh
from mceik_tpu.eikonal import EikonalConfig, solve_eikonal
from mceik_tpu.eikonal.dist_sweep import solve_eikonal_sharded
from mceik_tpu.grid import Grid


def _smooth(key, grid, amp=0.25):
    u = jax.random.normal(key, (4,) * grid.ndim)
    u = jax.image.resize(u, grid.shape, method="linear")
    return jnp.exp(amp * u)


@pytest.mark.parametrize("shape,src", [
    ((24, 17), [4.0, 8.0]),
    ((16, 11, 9), [3.0, 5.0, 4.0]),
])
def test_sharded_matches_unsharded(shape, src):
    grid = Grid(shape=shape, spacing=tuple(1.0 for _ in shape))
    s = _smooth(jax.random.PRNGKey(8), grid)
    src = jnp.asarray(src, jnp.float32)
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=200)
    T_ref = np.asarray(solve_eikonal(s, src, grid, cfg))

    mesh = chain_mesh(n_devices=8, axis="grid")
    T_sh = np.asarray(solve_eikonal_sharded(s, src, grid, mesh, "grid", cfg))
    np.testing.assert_allclose(T_sh, T_ref, atol=2e-3)


def test_sharded_on_two_devices():
    grid = Grid(shape=(20, 13), spacing=(1.0, 1.0))
    s = jnp.ones(grid.shape)
    src = jnp.asarray([9.5, 6.0], jnp.float32)
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=200)
    T_ref = np.asarray(solve_eikonal(s, src, grid, cfg))
    mesh = chain_mesh(n_devices=2, axis="grid")
    T_sh = np.asarray(solve_eikonal_sharded(s, src, grid, mesh, "grid", cfg))
    np.testing.assert_allclose(T_sh, T_ref, atol=2e-3)


def test_ulysses_reshard_matches_unsharded():
    """Station-axis reshard (forward/reshard.py, the Ulysses analog):
    grid-sharded tables -> all_to_all -> station-sharded gather must equal
    the single-device predict_events on replicated tables."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mceik_tpu.forward.predict import predict_events, traveltime_tables
    from mceik_tpu.forward.reshard import (predict_events_resharded,
                                           reshard_tables_to_stations)

    grid = Grid(shape=(16, 12, 9), spacing=(1.0, 1.0, 1.0))
    s = _smooth(jax.random.PRNGKey(3), grid)
    cfg = EikonalConfig(method="sweep", tol=1e-5, max_iters=100)
    key = jax.random.PRNGKey(4)
    n_sta, n_ev = 8, 5
    sta = jax.random.uniform(key, (n_sta, 3)) * jnp.asarray([15., 11., 8.])
    ev = jax.random.uniform(jax.random.fold_in(key, 1), (n_ev, 3)) * \
        jnp.asarray([15., 11., 8.])
    t0 = 0.1 * jax.random.normal(jax.random.fold_in(key, 2), (n_ev,))

    tables = traveltime_tables(s, sta, grid, cfg)
    t_ref = np.asarray(predict_events(tables, ev, t0, grid))

    mesh = chain_mesh(n_devices=4, axis="grid")
    # grid-shard the tables' leading GRID axis (axis 1 of the stacked array)
    tables_g = jax.device_put(tables, NamedSharding(mesh, P(None, "grid")))

    tables_s = reshard_tables_to_stations(tables_g, mesh, "grid")
    assert tables_s.shape == tables.shape
    np.testing.assert_allclose(np.asarray(tables_s), np.asarray(tables),
                               atol=1e-6)

    t_sh = np.asarray(predict_events_resharded(tables_g, ev, t0, grid,
                                               mesh, "grid"))
    np.testing.assert_allclose(t_sh, t_ref, atol=1e-5)
