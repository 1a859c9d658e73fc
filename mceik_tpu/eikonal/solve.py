"""Eikonal solver drivers: source seeding, Jacobi iteration, plane sweeps.

Replaces the reference's serial recursive sweep drivers (SURVEY.md §2.1
"Sweep scheduler 2-D/3-D", §3.2) with two data-parallel schemes:

- ``jacobi``: full-grid monotone updates in a bounded ``lax.while_loop``.
  Every node updates in parallel each iteration; information travels one
  node per iteration, so iterations ~ O(longest characteristic in nodes).
  All work is vectorized; this is also the fixed-point map the
  implicit adjoint differentiates.

- ``sweep``: directional plane sweeps. For each axis and direction, a
  ``lax.scan`` marches plane-by-plane carrying the just-updated previous
  plane (Gauss-Seidel along the swept axis, Jacobi transverse, with a few
  in-plane micro-iterations). One cycle = 2*D scans; like classic fast
  sweeping, a handful of cycles reaches the fixed point because
  information crosses the whole grid along the swept axis in one scan.

Both converge to the same Godunov upwind fixed point (tested against each
other and against analytic solutions).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.eikonal.godunov import BIG, godunov_update, local_solve, neighbor_min
from mceik_tpu.grid import Grid


@dataclasses.dataclass(frozen=True)
class EikonalConfig:
    """Static solver configuration (hashable; safe as a jit static arg).

    Attributes:
      method: "sweep" (default, fast) or "jacobi" (reference scheme).
      tol: max-abs traveltime change per outer iteration that counts as
        converged.
      max_iters: bound on Jacobi iterations / sweep cycles (while_loop is
        always bounded so jit never hangs).
      n_inner: in-plane micro-iterations per plane update (sweep only).
      seed_radius: source seed box radius, in units of max grid spacing.
    """

    method: str = "sweep"
    tol: float = 1e-4
    max_iters: int = 200
    n_inner: int = 2
    seed_radius: float = 3.0


def _index_grids(shape):
    """Per-axis node-index arrays of full grid shape."""
    return [
        lax.broadcasted_iota(jnp.float32, shape, dimension=d)
        for d in range(len(shape))
    ]


def seed_source(slowness: jnp.ndarray, src_xyz: jnp.ndarray, grid: Grid,
                seed_radius: float = 3.0):
    """Analytic traveltime seed in a ball around the source.

    The eikonal solution is singular at the point source; like the
    reference's source initializer (SURVEY.md §2.1 "Source initialization")
    we seed nodes within ``seed_radius * max(h)`` of the source with the
    locally homogeneous solution ``T = s(src) * ||x - x_src||`` and freeze
    them during iteration.

    Returns ``(T0, frozen_mask)``; unseeded nodes start at ``BIG``.
    """
    src_xyz = jnp.asarray(src_xyz, dtype=slowness.dtype)
    src_idx = grid.to_index_coords(src_xyz)  # fractional node coords, (D,)
    idx = _index_grids(slowness.shape)
    h = grid.spacing
    dist2 = sum(((idx[d] - src_idx[d]) * h[d]) ** 2 for d in range(grid.ndim))
    # Tiny floor: sqrt'(0) = inf would NaN source-position gradients at the
    # exact source node (0 * inf through the seed mask select).
    dist = jnp.sqrt(dist2 + 1e-12)
    radius = seed_radius * max(h)

    s_src = jax.scipy.ndimage.map_coordinates(
        slowness, [src_idx[d] for d in range(grid.ndim)], order=1, mode="nearest"
    )
    mask = dist <= radius
    T0 = jnp.where(mask, s_src * dist, BIG)
    return T0, mask


def _jacobi_solve(T0, frozen, s, spacing, tol, max_iters):
    def cond(carry):
        _, delta, it = carry
        return jnp.logical_and(delta > tol, it < max_iters)

    def body(carry):
        T, _, it = carry
        T_new = godunov_update(T, s, spacing)
        T_new = jnp.where(frozen, T0, T_new)
        delta = jnp.max(jnp.abs(T_new - T))
        return T_new, delta, it + 1

    T, _, _ = lax.while_loop(cond, body, (T0, jnp.asarray(jnp.inf, T0.dtype), 0))
    return T


def _plane_neighbor_min(Tp, axis_in_plane):
    return neighbor_min(Tp, axis_in_plane)


def _sweep_one_direction(T, frozen, T0, s, spacing, axis, reverse, n_inner):
    """One Gauss-Seidel plane sweep along ``axis`` (low->high or reversed)."""
    D = T.ndim
    # Move swept axis to front; flip for the reverse direction so the scan
    # always marches index 0 -> n-1.
    Tm = jnp.moveaxis(T, axis, 0)
    sm = jnp.moveaxis(s, axis, 0)
    fm = jnp.moveaxis(frozen, axis, 0)
    T0m = jnp.moveaxis(T0, axis, 0)
    if reverse:
        Tm, sm, fm, T0m = Tm[::-1], sm[::-1], fm[::-1], T0m[::-1]

    # "Next" plane (old values, downstream of the march) per step.
    T_next = jnp.concatenate(
        [Tm[1:], jnp.full_like(Tm[:1], BIG)], axis=0
    )
    # Spacing with the swept axis first, matching the moved layout.
    sp = (spacing[axis],) + tuple(spacing[d] for d in range(D) if d != axis)

    def step(prev_plane, xs):
        T_plane, T_next_plane, s_plane, f_plane, T0_plane = xs
        a_ax = jnp.minimum(prev_plane, T_next_plane)
        Tp = T_plane
        for _ in range(n_inner):
            a = [a_ax] + [
                _plane_neighbor_min(Tp, d) for d in range(Tp.ndim)
            ]
            Tp = jnp.minimum(Tp, local_solve(a, sp, s_plane))
            Tp = jnp.where(f_plane, T0_plane, Tp)
        return Tp, Tp

    init = jnp.full_like(Tm[0], BIG)
    _, Tm_new = lax.scan(step, init, (Tm, T_next, sm, fm, T0m))
    if reverse:
        Tm_new = Tm_new[::-1]
    return jnp.moveaxis(Tm_new, 0, axis)


def _sweep_cycle(T, frozen, T0, s, spacing, n_inner):
    for axis in range(T.ndim):
        for reverse in (False, True):
            T = _sweep_one_direction(T, frozen, T0, s, spacing, axis, reverse, n_inner)
    return T


def _sweep_solve(T0, frozen, s, spacing, tol, max_cycles, n_inner):
    def cond(carry):
        _, delta, it = carry
        return jnp.logical_and(delta > tol, it < max_cycles)

    def body(carry):
        T, _, it = carry
        T_new = _sweep_cycle(T, frozen, T0, s, spacing, n_inner)
        delta = jnp.max(jnp.abs(T_new - T))
        return T_new, delta, it + 1

    T, _, _ = lax.while_loop(cond, body, (T0, jnp.asarray(jnp.inf, T0.dtype), 0))
    return T


@partial(jax.jit, static_argnames=("grid", "config"))
def solve_eikonal(
    slowness: jnp.ndarray,
    src_xyz: jnp.ndarray,
    grid: Grid,
    config: EikonalConfig = EikonalConfig(),
) -> jnp.ndarray:
    """Solve |grad T| = slowness for first-arrival traveltimes from a point
    source at physical coordinates ``src_xyz``.

    Batched use: ``jax.vmap(solve_eikonal, in_axes=(None, 0, None, None))``
    over sources/stations (SURVEY.md §3.2, §3.5 traveltime tables).
    """
    if slowness.shape != grid.shape:
        raise ValueError(f"slowness shape {slowness.shape} != grid {grid.shape}")
    slowness = slowness.astype(jnp.float32)
    T0, frozen = seed_source(slowness, src_xyz, grid, config.seed_radius)
    if config.method == "jacobi":
        return _jacobi_solve(T0, frozen, slowness, grid.spacing, config.tol,
                             config.max_iters)
    if config.method == "sweep":
        return _sweep_solve(T0, frozen, slowness, grid.spacing, config.tol,
                            config.max_iters, config.n_inner)
    raise ValueError(f"unknown method {config.method!r}")
