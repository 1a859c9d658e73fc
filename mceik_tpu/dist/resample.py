"""Systematic resampling for sharded particle populations (SURVEY.md §2.3
"Particle parallelism", §3.4, §7 hard-part 4).

The reference gathers all particles to rank 0 over MPI and scatters back
[K]; here the resample *indices* are computed identically on every device
from the same PRNG key + globally-reduced weights, and the particle
exchange is a sharded ``jnp.take`` — XLA lowers the gather to the minimal
collective pattern. No coordinator, no user-level transport.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp


def systematic_indices(key, log_weights: jnp.ndarray) -> jnp.ndarray:
    """Systematic resampling indices (N,) from unnormalized log-weights.

    One shared uniform offset; low-variance stratified inversion of the
    weight CDF via searchsorted.
    """
    n = log_weights.shape[0]
    log_z = jax.scipy.special.logsumexp(log_weights)
    w = jnp.exp(log_weights - log_z)
    cdf = jnp.cumsum(w)
    cdf = cdf / cdf[-1]
    u = jax.random.uniform(key)
    positions = (u + jnp.arange(n, dtype=jnp.float32)) / n
    return jnp.clip(jnp.searchsorted(cdf, positions), 0, n - 1)


def resample_tree(tree: Any, indices: jnp.ndarray) -> Any:
    """Gather every leaf's leading (particle) axis by ``indices``."""
    return jax.tree.map(lambda x: jnp.take(x, indices, axis=0), tree)


def ess_from_log_weights(log_weights: jnp.ndarray) -> jnp.ndarray:
    """Effective sample size (Kish) of unnormalized log-weights."""
    lw = log_weights - jnp.max(log_weights)
    w = jnp.exp(lw)
    return jnp.square(jnp.sum(w)) / jnp.maximum(jnp.sum(w * w), 1e-30)
