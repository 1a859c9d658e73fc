"""Gauss-Seidel swept adjoint transport for the eikonal implicit VJP
(SURVEY.md §3.3 "grad of eikonal solve = ADJOINT sweep" — the HOT path of
NUTS/HMC over slowness fields).

The implicit-function VJP needs ``lambda`` solving the linear fixed point

    lambda = (dF/dT)^T lambda + g

where ``F`` is the stationarity map (adjoint.py). ``dF/dT`` is strictly
upwind: node ``i`` reads only its per-axis argmin neighbors, with weights
``w_d[i] = d local_solve / d a_d`` evaluated at the converged field. The
Jacobi iteration (one AD-vjp per step, adjoint.py) moves information ONE
cell per step, needing O(grid diameter) iterations and in practice hitting
its cap still unconverged. This module instead:

1. extracts the upwind weights ONCE by jvp of the local solver at the
   fixed point (exact consistency with what AD would use), together with
   the argmin direction per axis, packed as SIGNED weights (sign = which
   neighbor won, |w| = weight) so the transport state stays at D+2 fields;
2. solves the linear system by bidirectional plane-GS sweeps over every
   axis — the same iteration structure as the forward solver, converging
   in O(cycles) like fast sweeping, because the transpose system's
   information flows along reverse characteristics (receiver -> source)
   which alternating-direction sweeps cover in a few cycles.

The gather form used throughout: node ``j`` collects from each DOWNWIND
consumer ``i = j ± e_d`` that selected ``j`` as its axis-``d`` argmin:

    (W^T lam)[j] = sum_d  w_d[j+e_d] * lam[j+e_d] * [i=j+e_d chose lo]
                 + sum_d  w_d[j-e_d] * lam[j-e_d] * [i=j-e_d chose hi]

Frozen (source-seeded) nodes have a zero row in dF/dT (their F value is
the constant seed), so they contribute nothing and their lambda is g.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mceik_tpu.eikonal.godunov import BIG, local_solve, neighbor_min, shift_filled


def transport_weights(T, s, frozen, spacing) -> Tuple[jnp.ndarray, ...]:
    """Signed upwind weight fields at the converged point.

    Returns one array per axis: ``sign > 0`` means the node's axis-``d``
    argmin neighbor is the LOW side (i-1), ``sign < 0`` the HIGH side;
    ``|value| = d local_solve / d a_d`` (0 on frozen nodes / inactive
    axes). Computed by one ``jax.jvp`` per axis of the same local solver
    the forward sweep uses, so the weights are exactly AD's.
    """
    D = T.ndim
    a = tuple(neighbor_min(T, d) for d in range(D))
    f = lambda *a_: local_solve(list(a_), spacing, s)
    out = []
    nonfrozen = (~frozen).astype(T.dtype)
    for d in range(D):
        tangents = tuple(
            jnp.ones_like(T) if e == d else jnp.zeros_like(T)
            for e in range(D))
        _, w_d = jax.jvp(f, a, tangents)
        # Which neighbor is the argmin along d (ties -> low side, matching
        # jnp.minimum's tie-break in the forward AD path).
        is_lo = shift_filled(T, d, -1) <= shift_filled(T, d, +1)
        out.append(jnp.where(is_lo, w_d, -w_d) * nonfrozen)
    return tuple(out)


def apply_WT(lam, wsigned: Sequence[jnp.ndarray]):
    """Reference (Jacobi) application of ``(dF/dT)^T`` in gather form."""
    out = jnp.zeros_like(lam)
    for d, ws in enumerate(wsigned):
        send_lo = jnp.where(ws > 0, ws, 0.0) * lam       # to j = i-1
        send_hi = jnp.where(ws < 0, -ws, 0.0) * lam      # to j = i+1
        out += shift_filled(send_lo, d, +1, 0.0)          # out[j] = lo[j+1]
        out += shift_filled(send_hi, d, -1, 0.0)          # out[j] = hi[j-1]
    return out


def _axial_collect(lam_prev, lam_next, ws_prev, ws_next):
    """Contributions to a plane from its two axis-0 neighbor planes.

    ``lam_prev/ws_prev`` live at plane i-1 (a consumer there sends to us
    iff it chose its HIGH neighbor: ws < 0); ``lam_next/ws_next`` at plane
    i+1 (sends to us iff it chose LOW: ws > 0)."""
    from_prev = jnp.where(ws_prev < 0, -ws_prev, 0.0) * lam_prev
    from_next = jnp.where(ws_next > 0, ws_next, 0.0) * lam_next
    return from_prev + from_next


def _plane_collect_inplane(lam_p, ws_plane):
    """In-plane gather contributions within one plane (plane dims only)."""
    out = jnp.zeros_like(lam_p)
    for d, ws in enumerate(ws_plane):
        send_lo = jnp.where(ws > 0, ws, 0.0) * lam_p
        send_hi = jnp.where(ws < 0, -ws, 0.0) * lam_p
        out += shift_filled(send_lo, d, +1, 0.0)
        out += shift_filled(send_hi, d, -1, 0.0)
    return out


def _transport_plane_update(lam_p, base_p, ws_plane, n_inner):
    """GS plane update: lam = base + inplane(lam), micro-iterated."""
    for _ in range(n_inner):
        lam_p = base_p + _plane_collect_inplane(lam_p, ws_plane)
    return lam_p


def _transport_sweep_axis(lam, g, wsigned, axis, n_inner):
    """Bidirectional plane-GS sweep of the transport system along ``axis``
    (pure JAX / lax.scan)."""
    D = lam.ndim
    perm = (axis,) + tuple(d for d in range(D) if d != axis)
    inv = tuple(int(i) for i in np.argsort(perm))
    lam_t = jnp.transpose(lam, perm)
    g_t = jnp.transpose(g, perm)
    ws_t = [jnp.transpose(wsigned[p], perm) for p in perm]
    n0 = lam_t.shape[0]
    zero_plane = jnp.zeros_like(lam_t[0])

    def plane_at(lam_t, i):
        prev_l = jnp.where(i > 0, lam_t[jnp.maximum(i - 1, 0)], zero_plane)
        next_l = jnp.where(i < n0 - 1, lam_t[jnp.minimum(i + 1, n0 - 1)],
                           zero_plane)
        prev_w = jnp.where(i > 0, ws_t[0][jnp.maximum(i - 1, 0)], zero_plane)
        next_w = jnp.where(i < n0 - 1, ws_t[0][jnp.minimum(i + 1, n0 - 1)],
                           zero_plane)
        base = g_t[i] + _axial_collect(prev_l, next_l, prev_w, next_w)
        return _transport_plane_update(
            lam_t[i], base, [w[i] for w in ws_t[1:]], n_inner)

    def fwd(lam_t, i):
        lam_t = lam_t.at[i].set(plane_at(lam_t, i))
        return lam_t, None

    def bwd(lam_t, k):
        i = n0 - 1 - k
        lam_t = lam_t.at[i].set(plane_at(lam_t, i))
        return lam_t, None

    lam_t, _ = lax.scan(fwd, lam_t, jnp.arange(n0))
    lam_t, _ = lax.scan(bwd, lam_t, jnp.arange(n0))
    return jnp.transpose(lam_t, inv)


DIVERGENCE_FACTOR = 10.0


def _flagged_cycle_loop(cycle_fn, lam0, tol, max_cycles: int,
                        g_scale=None):
    """Shared transport cycle loop with DIVERGENCE detection (VERDICT r2
    next-step #4): GS on ``W^T`` is only a contraction when the upwind
    weight graph is (near-)causal — the wild slowness fields a barely
    warmed gradient chain visits can break that, and the residual then
    GROWS without bound (measured 3.9e5 vs tol 34.8 on an 8^3 grid,
    MULTICHIP_r02). A truncated-but-shrinking residual is benign
    (conservative near-converged lambda); a growing one means the lambda
    is garbage and must not be consumed silently.

    Policy: divergence = the cycle residual exceeding ``DIVERGENCE_FACTOR
    x`` the FIRST cycle's residual (or going nonfinite) — a contractive
    sweep's residual bounces non-monotonically between alternating sweep
    directions but never grows past its start, while true divergence grows
    geometrically every cycle. On detection the loop exits early and the
    returned lambda is POISONED with NaN. The NaN propagates through the
    VJP into the leapfrog, the proposal's logpost goes NaN, and the MH
    kernels reject + mark the step divergent through their existing
    nonfinite-log-ratio machinery (hmc.py/nuts.py) — the sampler stays
    exact, the event is visible in the divergent stat, and no host
    callback is needed (jax.debug.print both misfires under vmap batching
    — the cond lowers to select, firing for false predicates — and would
    need a host round trip)."""
    if g_scale is None:
        g_scale = jnp.max(jnp.abs(lam0))
    tol_eff = jnp.asarray(tol, jnp.float32) * (1e-3 + g_scale)

    def diverged_of(delta, d0):
        return jnp.logical_or(~jnp.isfinite(delta),
                              delta > DIVERGENCE_FACTOR * d0)

    def cond(carry):
        _, delta, d0, it = carry
        keep = jnp.logical_and(delta > tol_eff, it < max_cycles)
        div = jnp.logical_and(it >= 1, diverged_of(delta, d0))
        return jnp.logical_and(keep, ~div)

    def body(carry):
        lam, _, d0, it = carry
        lam_new = cycle_fn(lam)
        delta = jnp.max(jnp.abs(lam_new - lam))
        d0 = jnp.where(it == 0, delta, d0)     # first cycle's residual
        return lam_new, delta, d0, it + 1

    big = jnp.asarray(jnp.inf, jnp.float32)
    lam, delta, d0, it = lax.while_loop(
        cond, body, (lam0, big, jnp.asarray(0.0, jnp.float32), 0))
    diverged = jnp.logical_and(it >= 1, diverged_of(delta, d0))
    return jnp.where(diverged, jnp.nan, lam)


def transport_solve(g, wsigned, tol, max_cycles: int, n_inner: int = 2):
    """Solve ``lam = W^T lam + g`` by GS sweep cycles over all axes.

    ``wsigned``: per-axis signed weights from :func:`transport_weights`.
    Convergence: max|Delta lam| <= tol * (1e-3 + max|g|) per cycle, like
    the forward solver's criterion scaled to the cotangent magnitude.
    """
    def cycle(lam):
        for axis in range(g.ndim):
            lam = _transport_sweep_axis(lam, g, wsigned, axis, n_inner)
        return lam

    return _flagged_cycle_loop(cycle, g, tol, max_cycles)


def transport_solve_batched(g, T, s_b, srcs, grid, config):
    """Batched adjoint transport solve used by the implicit VJP.

    Args: ``g`` cotangent fields ``(B,) + grid.shape``; ``T`` converged
    traveltimes; ``s_b`` per-element slowness; ``srcs`` solve origins (for
    re-deriving the frozen seed masks). Vmapped pure-JAX sweeps on every
    platform; a sampler's chain ``vmap`` simply adds one more level.
    """
    from mceik_tpu.eikonal.solve import seed_source

    frozen = jax.vmap(
        lambda xi, si: seed_source(si, xi, grid, config.seed_radius)[1]
    )(srcs, s_b)
    ws = jax.vmap(
        lambda Ti, si, fi: transport_weights(Ti, si, fi, grid.spacing)
    )(T, s_b, frozen)
    return jax.vmap(
        lambda gi, *wsi: transport_solve(gi, tuple(wsi), config.tol,
                                         config.max_iters, config.n_inner)
    )(g, *ws)
