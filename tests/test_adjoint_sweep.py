"""Swept adjoint transport (eikonal/adjoint_sweep.py):
the GS-sweep solve of ``lam = (dF/dT)^T lam + g`` must agree with AD's
operator exactly and with the (slow) Jacobi iteration it replaces.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.eikonal.adjoint import _fixed_point_map
from mceik_tpu.eikonal.adjoint_sweep import (apply_WT, transport_solve,
                                             transport_weights)
from mceik_tpu.eikonal.solve import EikonalConfig, seed_source, solve_eikonal
from mceik_tpu.grid import Grid


@pytest.fixture(scope="module")
def problem():
    grid = Grid(shape=(14, 12, 10), spacing=(1.0, 1.2, 0.9))
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=100)
    key = jax.random.PRNGKey(0)
    s = 1.0 + 0.3 * jax.random.uniform(key, grid.shape)
    src = jnp.asarray([3.0, 6.0, 5.0], jnp.float32)
    T = solve_eikonal(s, src, grid, cfg)
    T0, frozen = seed_source(s, src, grid, cfg.seed_radius)
    ws = transport_weights(T, s, frozen, grid.spacing)
    F = lambda T_: _fixed_point_map(T_, s, src, grid, cfg)
    _, vjp_fn = jax.vjp(F, T)
    g = jax.random.normal(jax.random.fold_in(key, 2), grid.shape) * 0.1
    return grid, ws, vjp_fn, g


def test_weights_match_ad_operator(problem):
    """apply_WT with jvp-extracted weights == AD's (dF/dT)^T exactly."""
    grid, ws, vjp_fn, g = problem
    lam = jax.random.normal(jax.random.PRNGKey(7), grid.shape)
    np.testing.assert_allclose(np.asarray(apply_WT(lam, ws)),
                               np.asarray(vjp_fn(lam)[0]), atol=2e-6)


def test_gs_transport_solves_fixed_point(problem):
    """The swept solution satisfies lam = (dF/dT)^T lam + g under AD's
    operator (residual at fp32 epsilon), and matches long-run Jacobi."""
    grid, ws, vjp_fn, g = problem
    lam = transport_solve(g, ws, tol=1e-7, max_cycles=100)
    resid = lam - (vjp_fn(lam)[0] + g)
    assert float(jnp.max(jnp.abs(resid))) < 1e-5
    lam_j = g
    for _ in range(300):
        lam_j = vjp_fn(lam_j)[0] + g
    np.testing.assert_allclose(np.asarray(lam), np.asarray(lam_j), atol=1e-5)


def test_divergent_transport_flags_nan_not_silent_truncation():
    """VERDICT r2 #4: a transport system whose weight graph is NOT a
    contraction (spectral radius > 1 — the regime wild warmup fields
    produce) must come back POISONED (NaN), not as a silently truncated
    finite lambda. The NaN is what makes HMC/NUTS reject + mark the step
    divergent through their existing nonfinite-log-ratio handling."""
    shape = (8, 8)
    g = jnp.ones(shape, jnp.float32)
    # Alternating pull directions along each axis: node pairs (2k, 2k+1)
    # feed EACH OTHER with weight 1.3 — dependency cycles of gain 1.69,
    # spectral radius > 1, so no sweep ordering converges (an acyclic
    # all-one-direction graph would be triangular and GS-exact no matter
    # how large the weights).
    i = jnp.arange(shape[0])[:, None]
    j = jnp.arange(shape[1])[None, :]
    ws = (jnp.where(i % 2 == 0, -1.3, 1.3) * jnp.ones(shape, jnp.float32),
          jnp.where(j % 2 == 0, -1.3, 1.3) * jnp.ones(shape, jnp.float32))
    lam = transport_solve(g, ws, tol=1e-6, max_cycles=30)
    assert np.all(np.isnan(np.asarray(lam))), "divergence must poison lambda"


def test_contractive_transport_still_converges_clean(problem):
    """The divergence guard must not trip on a genuine (causal/upwind)
    system: same fixture as the fixed-point test, result finite and
    solving the system."""
    grid, ws, _, _ = problem
    g = jax.random.normal(jax.random.PRNGKey(5), grid.shape, jnp.float32)
    lam = transport_solve(g, ws, tol=1e-8, max_cycles=200)
    assert np.all(np.isfinite(np.asarray(lam)))
    resid = np.asarray(lam - (apply_WT(lam, ws) + g))
    assert np.max(np.abs(resid)) < 1e-4
