"""Whitened (Laplace-referenced) reparameterization of the posterior
(VERDICT r4 next-step #2: attack flagship-scale field mixing with the
levers the MALA diagnosis points at).

With ``x_map`` the MAP and ``C = L L^T`` the Gauss-Newton covariance
(model/laplace.py), sample in the whitened coordinates

    x = x_map + L u ,

where the target density over ``u`` is ``pi_u(u) = pi_x(x_map + L u)``
(the constant Jacobian |det L| drops). Running a sampler with IDENTITY
scales on ``u`` is exactly equivalent to giving it the DENSE GN
covariance/mass on ``x``:

- HMC/NUTS on ``u`` with unit diagonal mass == dense-mass (M = C^{-1})
  HMC/NUTS on ``x`` — multi-step trajectories that can track the
  position-dependent curvature the one-step pinned-covariance MALA
  proposal cannot (the r4 diagnosis: equilibrium whitened step 0.024,
  ~12x below the d^{-1/6} ideal, because the pinned GN covariance
  mismodels the prior-dominated soft subspace away from the MAP —
  BASELINE.md 2026-08-20).
- pCN on ``u`` with unit reference == GENERALIZED pCN w.r.t. the Laplace
  approximation N(x_map, C): proposal u' = sqrt(1-rho^2) u + rho xi,
  acceptance driven only by the NON-GAUSSIAN residual
  ``r(u) = logpost(x(u)) + ||u_active||^2 / 2`` — dimension-robust, one
  likelihood eval (no gradient) per step.

Frozen coordinates (prior scale 0): C carries unit diagonal / zero cross
terms there (gauss_newton_covariance's convention), the active mask
zeroes their u components inside the map, and samplers freeze them via
``scales_u`` (0 at frozen coords).

Cost: the map is one (d, d) @ (d,) matmul per logpost evaluation, small
next to an eikonal forward solve at d ~ 2k.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.samplers.am_full import _ravel, _unravel_fn

# float32 products: a TF32 default on the GPU would keep ~3 digits.
HIGHEST = lax.Precision.HIGHEST


@dataclasses.dataclass(frozen=True)
class WhitenedView:
    """u-space view of a posterior (see module docstring)."""

    logpost_u: Callable      # (d,) -> scalar, the whitened log target
    resid_u: Callable        # logpost_u + ||u_active||^2/2 (gpCN residual)
    params_of: Callable      # (d,) -> params pytree (x = x_map + L u)
    init_u: Callable         # (key) -> (d,) MAP-jittered init
    scales_u: jnp.ndarray    # (d,) 1.0 active / 0.0 frozen
    zero_u: jnp.ndarray      # (d,) zeros (example params for init_hyper)
    d: int


def whitened_view(posterior, p_map, cov, init_jitter: float = 0.3
                  ) -> WhitenedView:
    """Build the u-space view from a MAP + GN covariance.

    ``init_jitter``: chains start at u ~ init_jitter * N(0, I_active) —
    the same 0.3x-Laplace overdispersion the MALA path uses (full 1x
    draws land at logpost ~ -1e6 at flagship scale; api.py's init_one
    comment documents the measurement).
    """
    x_map = _ravel(p_map)
    active = (_ravel(posterior.prior_scales) > 0).astype(jnp.float32)
    L = jnp.linalg.cholesky(jnp.asarray(cov, jnp.float32))
    unravel = _unravel_fn(p_map)
    d = int(x_map.shape[0])

    def params_of(u):
        return unravel(x_map + jnp.matmul(L, active * u,
                                          precision=HIGHEST))

    def logpost_u(u):
        return posterior.logpost(params_of(u))

    def resid_u(u):
        ua = active * u
        return logpost_u(u) + 0.5 * jnp.sum(ua * ua)

    def init_u(key):
        return init_jitter * active * jax.random.normal(key, (d,), jnp.float32)

    return WhitenedView(logpost_u=logpost_u, resid_u=resid_u,
                        params_of=params_of, init_u=init_u,
                        scales_u=active, zero_u=jnp.zeros((d,), jnp.float32),
                        d=d)
