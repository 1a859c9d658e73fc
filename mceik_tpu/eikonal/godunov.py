"""Vectorized Godunov upwind local solver for the eikonal equation.

The reference's Fortran local solver updates one node at a time inside
nested sweep loops (SURVEY.md §2.1 "Eikonal local solver", §3.2). We
instead evaluate the same Godunov upwind update for *every* node of the grid
simultaneously as a branchless vector program (shifts, compares, selects,
one sqrt), and let the outer iteration (Jacobi or plane sweeps) handle
causality ordering.

Math (Zhao 2005 fast-sweeping local solver, anisotropic spacing): at each
node with per-axis upwind neighbor minima ``a_d`` and weights
``w_d = 1/h_d^2``, the update solves

    sum_d  w_d * max(t - a_d, 0)^2  =  s^2

for ``t``. With the ``a_d`` sorted ascending, try the smallest-n subsets:
``t_1 = a_1 + s*h_1``; if ``t_1 > a_2`` include the second axis, etc. The
n-term quadratic has the numerically stable discriminant

    disc_n = (sum w) * s^2 - sum_{i<j} w_i w_j (a_i - a_j)^2

(avoids the catastrophic cancellation of the naive ``B^2 - A*C`` form in
fp32, which matters because the whole solver runs in float32).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp

# Finite stand-in for +inf: keeps fp32 arithmetic NaN-free (inf - inf) while
# dominating any physical traveltime. BIG^2 = 1e20 is comfortably inside
# fp32 range.
BIG = 1e10

# Discriminant floor: keeps sqrt away from 0 so the VJP of the *unselected*
# where-branch can never be inf (0 * inf = NaN is the classic JAX pitfall);
# sqrt(1e-12) = 1e-6 is negligible against physical traveltimes.
_DISC_FLOOR = 1e-12


def shift_filled(T: jnp.ndarray, axis: int, delta: int, fill: float = BIG) -> jnp.ndarray:
    """``result[i] = T[i + delta]`` along ``axis``; out-of-range -> ``fill``.

    ``delta`` must be a static +1/-1.
    """
    n = T.shape[axis]
    sl = [slice(None)] * T.ndim
    if delta == 1:
        sl[axis] = slice(1, None)
        pad = [(0, 1) if d == axis else (0, 0) for d in range(T.ndim)]
    elif delta == -1:
        sl[axis] = slice(0, n - 1)
        pad = [(1, 0) if d == axis else (0, 0) for d in range(T.ndim)]
    else:
        raise ValueError(f"delta must be +-1, got {delta}")
    return jnp.pad(T[tuple(sl)], pad, constant_values=fill)


def neighbor_min(T: jnp.ndarray, axis: int, fill: float = BIG) -> jnp.ndarray:
    """Per-node minimum of the two axis-neighbors (edge -> ``fill``)."""
    return jnp.minimum(shift_filled(T, axis, +1, fill), shift_filled(T, axis, -1, fill))


def _sort3(a1, w1, a2, w2, a3, w3):
    """Sort three (a, w) pairs by ``a`` with a 3-element sorting network."""

    def cswap(ax, wx, ay, wy):
        swap = ay < ax
        return (
            jnp.where(swap, ay, ax),
            jnp.where(swap, wy, wx),
            jnp.where(swap, ax, ay),
            jnp.where(swap, wx, wy),
        )

    a1, w1, a2, w2 = cswap(a1, w1, a2, w2)
    a2, w2, a3, w3 = cswap(a2, w2, a3, w3)
    a1, w1, a2, w2 = cswap(a1, w1, a2, w2)
    return a1, w1, a2, w2, a3, w3


def _sort3_vals(a1, a2, a3):
    """Sort three arrays elementwise with a 3-element sorting network."""
    lo, hi = jnp.minimum(a1, a2), jnp.maximum(a1, a2)
    a3, hi = jnp.minimum(a3, hi), jnp.maximum(a3, hi)
    lo, a3 = jnp.minimum(lo, a3), jnp.maximum(lo, a3)
    return lo, a3, hi


def _local_solve_iso(a: Sequence[jnp.ndarray], h: float, s: jnp.ndarray):
    """Equal-spacing specialization of :func:`local_solve`.

    With all weights equal (w = 1/h^2) the sorted-subset quadratics have
    weight-free closed forms — no per-node ``sqrt(1/w)``, no divisions, and
    the sorting network needn't carry weights (halves its selects):

        t1 = a1 + s h
        t2 = (a1 + a2)/2 + sqrt(2 s^2 h^2 - (a1 - a2)^2)/2
        t3 = (a1+a2+a3)/3 + sqrt(3 s^2 h^2 - sum_{i<j}(a_i - a_j)^2)/3

    This is the hot scalar program of the Pallas sweep kernels (all bench
    workloads use isotropic grids), so the op count here is throughput.
    """
    s2h2 = (s * s) * (h * h)
    if len(a) == 2:
        a1 = jnp.minimum(a[0], a[1])
        a2 = jnp.maximum(a[0], a[1])
        t1 = a1 + s * h
        d12 = a1 - a2
        t2 = 0.5 * ((a1 + a2) + jnp.sqrt(
            jnp.maximum(2.0 * s2h2 - d12 * d12, _DISC_FLOOR)))
        return jnp.where(t1 <= a2, t1, t2)

    a1, a2, a3 = _sort3_vals(a[0], a[1], a[2])
    t1 = a1 + s * h
    d12 = a1 - a2
    t2 = 0.5 * ((a1 + a2) + jnp.sqrt(
        jnp.maximum(2.0 * s2h2 - d12 * d12, _DISC_FLOOR)))
    d13 = a1 - a3
    d23 = a2 - a3
    t3 = (1.0 / 3.0) * ((a1 + a2 + a3) + jnp.sqrt(jnp.maximum(
        3.0 * s2h2 - (d12 * d12 + d13 * d13 + d23 * d23), _DISC_FLOOR)))
    return jnp.where(t1 <= a2, t1, jnp.where(t2 <= a3, t2, t3))


def local_solve(
    a: Sequence[jnp.ndarray],
    spacing: Sequence[float],
    s: jnp.ndarray,
) -> jnp.ndarray:
    """Solve the Godunov upwind quadratic at every node.

    Args:
      a: per-axis upwind neighbor minima (D arrays of grid shape).
      spacing: per-axis grid spacing (static floats, length D in {2, 3}).
      s: slowness, grid shape.

    Returns:
      Candidate traveltime ``t`` per node (not yet min'd with the current T).
    """
    D = len(a)
    if D in (2, 3) and len(set(float(h) for h in spacing)) == 1:
        return _local_solve_iso(a, float(spacing[0]), s)
    w = [1.0 / (h * h) for h in spacing]
    s2 = s * s

    if D == 2:
        a1, w1, a2, w2 = a[0], jnp.full_like(a[0], w[0]), a[1], jnp.full_like(a[1], w[1])
        swap = a2 < a1
        a1, a2 = jnp.where(swap, a2, a1), jnp.where(swap, a1, a2)
        w1, w2 = jnp.where(swap, w2, w1), jnp.where(swap, w1, w2)

        t1 = a1 + s * jnp.sqrt(1.0 / w1)
        A2 = w1 + w2
        B2 = w1 * a1 + w2 * a2
        disc2 = A2 * s2 - w1 * w2 * (a1 - a2) ** 2
        t2 = (B2 + jnp.sqrt(jnp.maximum(disc2, _DISC_FLOOR))) / A2
        return jnp.where(t1 <= a2, t1, t2)

    if D == 3:
        a1 = a[0]
        a2 = a[1]
        a3 = a[2]
        w1 = jnp.full_like(a1, w[0])
        w2 = jnp.full_like(a2, w[1])
        w3 = jnp.full_like(a3, w[2])
        a1, w1, a2, w2, a3, w3 = _sort3(a1, w1, a2, w2, a3, w3)

        t1 = a1 + s * jnp.sqrt(1.0 / w1)

        A2 = w1 + w2
        B2 = w1 * a1 + w2 * a2
        disc2 = A2 * s2 - w1 * w2 * (a1 - a2) ** 2
        t2 = (B2 + jnp.sqrt(jnp.maximum(disc2, _DISC_FLOOR))) / A2

        A3 = A2 + w3
        B3 = B2 + w3 * a3
        disc3 = A3 * s2 - (
            w1 * w2 * (a1 - a2) ** 2
            + w1 * w3 * (a1 - a3) ** 2
            + w2 * w3 * (a2 - a3) ** 2
        )
        t3 = (B3 + jnp.sqrt(jnp.maximum(disc3, _DISC_FLOOR))) / A3

        t = jnp.where(t1 <= a2, t1, jnp.where(t2 <= a3, t2, t3))
        return t

    raise ValueError(f"only 2-D/3-D grids supported, got D={D}")


def godunov_update(
    T: jnp.ndarray,
    s: jnp.ndarray,
    spacing: Tuple[float, ...],
) -> jnp.ndarray:
    """One monotone Jacobi pass: update every node from its neighbors.

    ``T_new = min(T, local_solve(neighbor minima))`` — values only decrease,
    so iterating from ``T = BIG`` (with frozen source seeds) converges
    monotonically to the viscosity solution fixed point. This operator is
    also the fixed-point map ``F`` used by the implicit-function adjoint
    (SURVEY.md §7 M5).
    """
    a = [neighbor_min(T, d) for d in range(T.ndim)]
    return jnp.minimum(T, local_solve(a, spacing, s))
