"""Public batched eikonal solve with vmap-merging (SURVEY.md §3.2's
"station-batched solves" — the per-proposal hot loop).

``solve_eikonal_batched`` solves one traveltime field per source over a
shared (or per-source) slowness field. Its ``jax.custom_batching.custom_vmap``
rule COLLAPSES any outer ``vmap`` axis (chains, events, ...) into the flat
batch, so a sampler's ``vmap_chains(vmap_stations(solve))`` reaches the
solver as ONE rank-1 batch. The GPU kernel (sweep_kernel.py) runs one
program per field of that batch: the whole chains x sources batch then
goes out in one launch and spreads over the card's SMs, instead of one
launch per chain.

Routing is decided by the platform the solve is lowered for, in one place
(``_solve_flat``): the CUDA lowering of a 3-D sweep solve runs the kernel,
every other lowering (CPU, and 2-D grids anywhere) the plain vmapped XLA
sweep.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.eikonal.solve import (EikonalConfig, _jacobi_solve,
                                     _sweep_solve, seed_source)
from mceik_tpu.grid import Grid


def xla_solve(T0, frozen, s, grid: Grid, config: EikonalConfig):
    """Plain reference: the vmapped XLA solve of a flat batch."""
    if config.method == "jacobi":
        f = lambda T0_, fr_, s_: _jacobi_solve(T0_, fr_, s_, grid.spacing,
                                               config.tol, config.max_iters)
    else:
        f = lambda T0_, fr_, s_: _sweep_solve(T0_, fr_, s_, grid.spacing,
                                              config.tol, config.max_iters,
                                              config.n_inner)
    return jax.vmap(f)(T0, frozen, s)


def kernel_solve(T0, frozen, s, grid: Grid, config: EikonalConfig,
                 interpret: bool = False):
    """The GPU kernel on a flat batch of 3-D fields (sweep method)."""
    floor = jnp.where(frozen, T0, 0.0)
    return _batch_sharded_kernel(grid.spacing, config.tol, config.max_iters,
                                 config.n_inner, interpret)(T0, floor, s)


@functools.lru_cache(maxsize=64)
def _batch_sharded_kernel(spacing, tol, max_cycles, n_inner, interpret):
    """The kernel as an op the SPMD partitioner may split along the batch.

    XLA cannot look inside a kernel call, so by default it gathers a
    sharded batch onto every device and solves all of it there. The fields
    are independent, so when chains are sharded over a mesh each device
    solves only its own fields instead.
    """
    from jax.experimental.custom_partitioning import custom_partitioning
    from jax.sharding import NamedSharding, PartitionSpec

    from mceik_tpu.eikonal.sweep_kernel import sweep_solve_batched

    def solve(T0, floor, s):
        return sweep_solve_batched(T0, floor, s, spacing, tol, max_cycles,
                                   n_inner, interpret=interpret)

    def batch_sharding(mesh, arg_shapes):
        spec = arg_shapes[0].sharding.spec
        return NamedSharding(mesh, PartitionSpec(spec[0] if spec else None))

    def partition(mesh, arg_shapes, result_shape):
        sharding = batch_sharding(mesh, arg_shapes)
        return mesh, solve, sharding, (sharding,) * 3

    op = custom_partitioning(solve)
    op.def_partition(
        infer_sharding_from_operands=lambda mesh, arg_shapes, _: (
            batch_sharding(mesh, arg_shapes)),
        partition=partition,
        sharding_rule="b x y z, b x y z, b x y z -> b x y z")
    return op


def _solve_flat(T0, frozen, s, grid: Grid, config: EikonalConfig):
    xla = functools.partial(xla_solve, grid=grid, config=config)
    if config.method != "sweep" or grid.ndim != 3:
        return xla(T0, frozen, s)
    kernel = functools.partial(kernel_solve, grid=grid, config=config)
    return lax.platform_dependent(T0, frozen, s, cuda=kernel, default=xla)


@functools.lru_cache(maxsize=64)
def _core_solver(grid: Grid, config: EikonalConfig):
    """Build (and cache) the custom_vmap'd flat solver for a grid+config.

    The core takes ``(srcs (B, D), s (B,) + grid.shape)`` and performs
    seeding + solve entirely inside the flattening boundary.
    """

    @jax.custom_batching.custom_vmap
    def solve_core(srcs, s):
        T0, frozen = jax.vmap(
            lambda x, sf: seed_source(sf, x, grid, config.seed_radius)
        )(srcs, s)
        return _solve_flat(T0, frozen, s, grid, config)

    @solve_core.def_vmap
    def _rule(axis_size, in_batched, srcs, s):
        def ensure(x, b):
            return x if b else jnp.broadcast_to(x[None], (axis_size,) + x.shape)

        srcs_b = ensure(srcs, in_batched[0])
        s_b = ensure(s, in_batched[1])
        inner = srcs_b.shape[1]

        def flat(x):
            return x.reshape((axis_size * inner,) + x.shape[2:])

        out = solve_core(flat(srcs_b), flat(s_b))
        return out.reshape((axis_size, inner) + out.shape[1:]), True

    return solve_core


def solve_eikonal_batched(slowness, srcs, grid: Grid,
                          config: EikonalConfig = EikonalConfig()):
    """Solve from ``(B, D)`` source coords; ``slowness`` is grid-shaped
    (shared) or ``(B,) + grid.shape`` (per-source). Returns
    ``(B,) + grid.shape`` traveltime fields.
    """
    slowness = jnp.asarray(slowness, jnp.float32)
    B = srcs.shape[0]
    if slowness.ndim == grid.ndim:
        s_b = jnp.broadcast_to(slowness, (B,) + grid.shape)
    else:
        s_b = slowness
    return _core_solver(grid, config)(srcs, s_b)
