"""Parameter pytree and reparameterizations.

All parameters live in an *unconstrained* basis so every sampler (RWM, AM,
HMC, NUTS, SMC mutation) works on R^n without per-sampler special cases:

- slowness: coarse log-deviation field ``u`` (inversion grid), upsampled to
  the forward grid; ``s = s_bg * exp(upsample(u))`` — positive by
  construction. The coarse basis is both the smoothness prior and the
  reason finite-chain MCMC can recover structure (the reference family
  likewise inverts on a coarser grid than the forward solver runs on).
- hypocenters: unconstrained ``hypo_raw`` mapped into the grid box by a
  scaled sigmoid; uniform-in-box prior becomes a logistic Jacobian term.
- origin times ``t0``: Gaussian, already unconstrained.
- noise: ``log_sigma`` deviations (scalar or per-station), Gaussian
  hyperprior (config 5's hierarchical noise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.grid import Grid


@pytree_dataclass
class Params:
    u: Optional[jnp.ndarray] = None          # (inv_shape) log-slowness deviation
    hypo_raw: Optional[jnp.ndarray] = None   # (n_ev, D) unconstrained
    t0: Optional[jnp.ndarray] = None         # (n_ev,)
    log_sigma: Optional[jnp.ndarray] = None  # () or (n_sta,)
    # Spike-slab noise indicators (n_sta,) in {0.,1.} — trans-dimensional
    # noise components. Stored as float so the chain state stays one dtype;
    # frozen under every continuous kernel (prior scale 0) and moved only
    # by the posterior's exact Gibbs sweep (posterior.noise_gibbs).
    noise_z: Optional[jnp.ndarray] = None


def slowness_from_u(u: jnp.ndarray, grid: Grid, background: jnp.ndarray) -> jnp.ndarray:
    """Coarse unconstrained field -> positive slowness on the forward grid."""
    up = jax.image.resize(u, grid.shape, method="linear")
    return background * jnp.exp(up)


def box_from_raw(hypo_raw: jnp.ndarray, grid: Grid, margin: float = 0.0) -> jnp.ndarray:
    """Sigmoid-map unconstrained coords into the grid's physical box."""
    lo = jnp.asarray(grid.origin, dtype=hypo_raw.dtype) + margin
    hi = lo + jnp.asarray(grid.extent, dtype=hypo_raw.dtype) - 2 * margin
    return lo + (hi - lo) * jax.nn.sigmoid(hypo_raw)


def box_logjac(hypo_raw: jnp.ndarray) -> jnp.ndarray:
    """log|d box / d raw| summed (uniform-in-box prior in raw coords),
    dropping the constant log(hi-lo) terms."""
    return jnp.sum(jax.nn.log_sigmoid(hypo_raw) + jax.nn.log_sigmoid(-hypo_raw))


def raw_from_box(xyz: jnp.ndarray, grid: Grid, margin: float = 0.0) -> jnp.ndarray:
    """Inverse of :func:`box_from_raw` (for initializing chains at points)."""
    lo = jnp.asarray(grid.origin, dtype=xyz.dtype) + margin
    hi = lo + jnp.asarray(grid.extent, dtype=xyz.dtype) - 2 * margin
    p = jnp.clip((xyz - lo) / (hi - lo), 1e-5, 1 - 1e-5)
    return jnp.log(p) - jnp.log1p(-p)
