"""Grid-sharded (domain-decomposed) eikonal solve (SURVEY.md §2.3 "SP/CP"
and "Ring attention" analogs, §5 "Long-context / sequence parallelism").

For fields that pressure a single chip's HBM (128^3+ x station batches),
the 3-D grid is sharded along its leading axis over a ``Mesh`` axis; each
device sweeps its slab and exchanges one boundary plane per side per
iteration with its neighbors via ``lax.ppermute`` (neighbor-only, ring
shaped), i.e. block-parallel fast sweeping (Zhao-2007 style):

    while not converged (global pmax of per-slab deltas):
        halo_lo = ppermute(T_slab[-1], shift +1)   # from lower neighbor
        halo_hi = ppermute(T_slab[0],  shift -1)   # from upper neighbor
        T_ext = concat([halo_lo, T_slab, halo_hi]) # BIG at outer edges
        T_ext = sweep_cycle(T_ext)                 # local (XLA or Pallas)
        T_slab = T_ext interior

The local cycle is the same single-device sweep kernel family; the fixed
point equals the unsharded solver's (tested on the 8-virtual-device CPU
mesh, sharded == unsharded to tolerance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mceik_tpu.eikonal.godunov import BIG
from mceik_tpu.eikonal.solve import EikonalConfig, _sweep_cycle, seed_source
from mceik_tpu.grid import Grid


def solve_eikonal_sharded(
    slowness: jnp.ndarray,
    src_xyz: jnp.ndarray,
    grid: Grid,
    mesh: Mesh,
    axis_name: str = "grid",
    config: EikonalConfig = EikonalConfig(),
) -> jnp.ndarray:
    """Solve with the leading grid axis sharded over ``mesh[axis_name]``.

    ``slowness`` may be replicated or already sharded; the result is
    sharded along the leading axis.
    """
    n_dev = mesh.shape[axis_name]
    n0 = grid.shape[0]
    if n0 % n_dev != 0:
        raise ValueError(f"grid axis 0 ({n0}) must divide over {n_dev} devices")

    slowness = slowness.astype(jnp.float32)
    T0, frozen = seed_source(slowness, src_xyz, grid, config.seed_radius)
    T0f = jnp.where(frozen, T0, 0.0).astype(jnp.float32)  # seed floor

    perm_fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    perm_bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    spec = P(axis_name)
    rep = P()

    @partial(jax.shard_map, mesh=mesh, in_specs=(spec, spec, spec),
             out_specs=spec)
    def run(T_slab, s_slab, floor_slab):
        my = lax.axis_index(axis_name)
        big_plane = jnp.full_like(T_slab[:1], BIG)

        def body(carry):
            T, _, it = carry
            # Halo exchange: my last plane -> next device's lower halo;
            # my first plane -> previous device's upper halo.
            halo_lo = lax.ppermute(T[-1:], axis_name, perm_fwd)
            halo_hi = lax.ppermute(T[:1], axis_name, perm_bwd)
            halo_lo = jnp.where(my == 0, big_plane, halo_lo)
            halo_hi = jnp.where(my == n_dev - 1, big_plane, halo_hi)

            T_ext = jnp.concatenate([halo_lo, T, halo_hi], axis=0)
            s_ext = jnp.concatenate([s_slab[:1], s_slab, s_slab[-1:]], axis=0)
            f_ext = jnp.concatenate([jnp.zeros_like(floor_slab[:1]),
                                     floor_slab,
                                     jnp.zeros_like(floor_slab[:1])], axis=0)
            # Freeze the halo planes at their exchanged values so the local
            # sweep reads them but cannot corrupt them: floor == value
            # pins a plane under the monotone max-floor restore.
            f_ext = f_ext.at[0].set(halo_lo[0]).at[-1].set(halo_hi[0])
            T0_ext = f_ext

            frozen_ext = f_ext > 0.0
            T_new_ext = _sweep_cycle(T_ext, frozen_ext, T0_ext, s_ext,
                                     grid.spacing, config.n_inner)
            T_new = T_new_ext[1:-1]
            delta = jnp.max(jnp.abs(T_new - T))
            delta = lax.pmax(delta, axis_name)
            return T_new, delta, it + 1

        def cond(carry):
            _, delta, it = carry
            return jnp.logical_and(delta > config.tol, it < config.max_iters)

        T, _, _ = lax.while_loop(
            cond, body, (T_slab, jnp.asarray(jnp.inf, jnp.float32), 0))
        return T

    sharding = NamedSharding(mesh, spec)
    T0s = jax.device_put(T0, sharding)
    ss = jax.device_put(slowness, sharding)
    fs = jax.device_put(T0f, sharding)
    return run(T0s, ss, fs)
