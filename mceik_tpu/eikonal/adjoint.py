"""Differentiable eikonal solve via the implicit-function adjoint
(SURVEY.md §7 M5, §3.3; reference capability per BASELINE.json "NUTS/HMC
over slowness fields").

Unrolling sweep iterations through AD is memory-infeasible; instead we use
the fixed-point structure. The converged field satisfies ``T* = F(T*, s)``
with ``F`` the monotone Godunov update (godunov.godunov_update plus frozen
source seeding). The VJP of ``solve`` w.r.t. slowness is

    lambda = (dF/dT)^T lambda + g        (linear fixed point, g = dL/dT*)
    dL/ds  = (dF/ds)^T lambda

where each application of ``(dF/dT)^T`` is one ``jax.vjp`` of the cheap
one-step update at the converged point — an upwind *transport* operator
whose iteration converges in at most O(grid diameter) steps (information
flows along reverse characteristics; the Jacobian is effectively nilpotent
on the upwind DAG). No sweep history is ever stored: residuals are just
``(s, src, T*)``.

Gradients w.r.t. the source position flow through the analytic seed and are
returned too (hypocenter gradients normally bypass the solver entirely via
reciprocity — see forward/predict.py — but locate-style uses get them for
free here).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.eikonal.godunov import godunov_update
from mceik_tpu.eikonal.solve import EikonalConfig, seed_source, solve_eikonal
from mceik_tpu.grid import Grid


def _fixed_point_map(T, slowness, src_xyz, grid: Grid, config: EikonalConfig):
    """Stationarity map whose fixed point is the converged field.

    IMPORTANT: this is ``local_solve`` WITHOUT the outer monotone
    ``min(T, .)`` that the forward iteration uses. At convergence every
    non-frozen node satisfies ``T* = local(T*)`` *exactly* (the last update
    that changed the node set it to a local value, and stationarity forces
    equality), so both maps have the same fixed point — but the monotone
    form is everywhere at a ``min`` TIE there, and ``jnp.minimum``'s
    tie-breaking routes the cotangent into the identity branch, silently
    corrupting the adjoint (measured ~20% gradient error). The pure local
    form has zero diagonal (a node never reads itself), making dF/dT
    strictly upwind and the adjoint iteration exactly convergent.
    """
    from mceik_tpu.eikonal.godunov import local_solve, neighbor_min

    T0, frozen = seed_source(slowness, src_xyz, grid, config.seed_radius)
    a = [neighbor_min(T, d) for d in range(T.ndim)]
    T_new = local_solve(a, grid.spacing, slowness)
    return jnp.where(frozen, T0, T_new)


@partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def solve_eikonal_diff(slowness, src_xyz, grid: Grid,
                       config: EikonalConfig = EikonalConfig()):
    """Like solve_eikonal, but differentiable w.r.t. slowness (and source
    position) through the implicit adjoint."""
    return solve_eikonal(slowness, src_xyz, grid, config)


def _fwd(slowness, src_xyz, grid, config):
    T = solve_eikonal(slowness, src_xyz, grid, config)
    return T, (slowness, src_xyz, T)


def _bwd(grid, config, residuals, g):
    # Swept GS transport (adjoint_sweep.py), same scheme as the batched
    # path: the per-cell Jacobi iteration this replaces moved information
    # one cell per step and in practice hit its cap still unconverged
    # (measured 192/192 iters, residual 5e-2 on 32^3 — BASELINE.md
    # 2026-08-18). The sweep converges in O(cycles) and warns loudly if
    # the cycle cap is ever hit (no silently truncated gradients).
    from mceik_tpu.eikonal.adjoint_sweep import (transport_solve,
                                                 transport_weights)

    slowness, src_xyz, T = residuals
    slowness = slowness.astype(jnp.float32)

    F = lambda T_, s_, x_: _fixed_point_map(T_, s_, x_, grid, config)
    _, vjp_fn = jax.vjp(F, T, slowness, src_xyz)

    _, frozen = seed_source(slowness, src_xyz, grid, config.seed_radius)
    ws = transport_weights(T, slowness, frozen, grid.spacing)
    lam = transport_solve(g, ws, config.tol, config.max_iters,
                          config.n_inner)

    _, ds, dsrc = vjp_fn(lam)
    return ds, dsrc


solve_eikonal_diff.defvjp(_fwd, _bwd)


# ---------------------------------------------------------------------------
# Batched differentiable solve: custom_vjp( flat batch ).
#
#   forward: the flat-batch route (batched.solve_eikonal_batched — the GPU
#            kernel on CUDA, the vmapped XLA sweep elsewhere)
#   backward: a flat-batch adjoint transport (adjoint_sweep.py)
#   batching: custom_vjp's own batching rule vmaps fwd/bwd; the fwd's
#             INTERNAL flat-batch boundary (batched.py's custom_vmap, in
#             the non-differentiated region) then merges the axes. (An
#             outer custom_vmap was tried and rejected: custom_vmap does
#             not compose with jax.grad.)
# ---------------------------------------------------------------------------

import functools as _functools


@_functools.lru_cache(maxsize=64)
def _diff_core(grid: Grid, config: EikonalConfig):
    from mceik_tpu.eikonal.batched import solve_eikonal_batched

    @jax.custom_vjp
    def solve_flat(s_b, srcs):
        return solve_eikonal_batched(s_b, srcs, grid, config)

    def fwd(s_b, srcs):
        T = solve_flat(s_b, srcs)
        return T, (s_b, srcs, T)

    def bwd(res, g):
        # lambda via Gauss-Seidel SWEPT transport (adjoint_sweep.py): the
        # same alternating-direction plane-sweep iteration as the forward
        # solver, converging in O(cycles) — the per-cell Jacobi iteration
        # this replaces needed O(grid diameter) steps and in practice hit
        # its cap still unconverged (measured: 192/192 iters, residual 5e-2
        # on 32^3). Weights come from one jvp per axis of the SAME local
        # solver AD differentiates, so the linear system is exactly AD's.
        from mceik_tpu.eikonal.adjoint_sweep import transport_solve_batched

        s_b, srcs, T = res
        s_b = s_b.astype(jnp.float32)

        def F(T_, s_, x_):
            return jax.vmap(
                lambda Ti, si, xi: _fixed_point_map(Ti, si, xi, grid, config)
            )(T_, s_, x_)

        _, vjp_fn = jax.vjp(F, T, s_b, srcs)
        lam = transport_solve_batched(g, T, s_b, srcs, grid, config)
        # Final (ds, dsrc) via one exact AD application of (dF/d.)^T.
        _, ds, dsrc = vjp_fn(lam)
        return ds, dsrc

    solve_flat.defvjp(fwd, bwd)
    return solve_flat


def solve_eikonal_diff_batched(slowness, srcs, grid: Grid,
                               config: EikonalConfig = EikonalConfig()):
    """Differentiable batched solve from ``(B, D)`` sources; gradients
    w.r.t. slowness (and sources) via the flat-batch implicit adjoint."""
    slowness = jnp.asarray(slowness, jnp.float32)
    B = srcs.shape[0]
    if slowness.ndim == grid.ndim:
        s_b = jnp.broadcast_to(slowness, (B,) + grid.shape)
    else:
        s_b = slowness
    return _diff_core(grid, config)(s_b, srcs)
