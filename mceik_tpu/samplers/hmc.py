"""Hamiltonian Monte Carlo with dual-averaging step size and diagonal mass
matrix (SURVEY.md §2.1 "HMC/NUTS", §3.3; the NUTS variant builds on these
same pieces in nuts.py).

Leapfrog runs as a ``lax.scan`` so the whole trajectory jit-fuses with the
(differentiable) forward model; gradients of the eikonal solve come from
the implicit adjoint (eikonal/adjoint.py), matching SURVEY.md §2.2 N7.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.diag.moments import Welford, welford_init, welford_update_batch
from mceik_tpu.samplers.base import MHState
from mceik_tpu.utils import tree_dot, tree_random_normal, tree_where


@pytree_dataclass
class DualAveraging:
    mu: jnp.ndarray
    log_eps: jnp.ndarray
    log_eps_bar: jnp.ndarray
    h_bar: jnp.ndarray


@pytree_dataclass
class HMCHyper:
    da: DualAveraging
    inv_mass: Any        # diagonal inverse mass, pytree like params
    welford: Welford     # pooled position moments -> mass adaptation
    scales: Any          # prior scales (mass fallback until welford ready)


def init_hyper(scales: Any, step_size: float, example_params: Any) -> HMCHyper:
    log_eps = jnp.asarray(jnp.log(step_size), jnp.float32)
    da = DualAveraging(mu=jnp.log(10.0) + log_eps, log_eps=log_eps,
                       log_eps_bar=log_eps, h_bar=jnp.asarray(0.0, jnp.float32))
    inv_mass = jax.tree.map(lambda s: s * s, scales)
    return HMCHyper(da=da, inv_mass=inv_mass,
                    welford=welford_init(example_params), scales=scales)


def kinetic(p: Any, inv_mass: Any) -> jnp.ndarray:
    return 0.5 * tree_dot(p, jax.tree.map(jnp.multiply, inv_mass, p))


def leapfrog(value_and_grad: Callable, q: Any, p: Any, eps, inv_mass: Any,
             n_steps: int):
    """n_steps of leapfrog; returns (q, p, logpost(q), grad(q))."""
    lp, g = value_and_grad(q)

    def step(carry, _):
        q, p, lp, g = carry
        p = jax.tree.map(lambda pi, gi: pi + 0.5 * eps * gi, p, g)
        q = jax.tree.map(lambda qi, pi, mi: qi + eps * mi * pi, q, p, inv_mass)
        lp, g = value_and_grad(q)
        p = jax.tree.map(lambda pi, gi: pi + 0.5 * eps * gi, p, g)
        return (q, p, lp, g), None

    (q, p, lp, g), _ = lax.scan(step, (q, p, lp, g), None, length=n_steps)
    return q, p, lp, g


def make_kernel(logpost_fn: Callable, n_leapfrog: int,
                jitter: float = 0.2) -> Callable:
    """HMC transition. ``jitter`` randomizes eps per step by U(1-j, 1+j)
    to decorrelate trajectory lengths."""
    value_and_grad = jax.value_and_grad(logpost_fn)

    def kernel(key, state: MHState, hyper: HMCHyper):
        k_mom, k_acc, k_jit = jax.random.split(key, 3)
        inv_mass = hyper.inv_mass
        eps = jnp.exp(hyper.da.log_eps)
        eps = eps * (1.0 + jitter * (2.0 * jax.random.uniform(k_jit) - 1.0))

        # p ~ N(0, M) with M = diag(1/inv_mass): p = xi / sqrt(inv_mass).
        xi = tree_random_normal(k_mom, state.params)
        p0 = jax.tree.map(lambda x, mi: x * jax.lax.rsqrt(jnp.maximum(mi, 1e-12)),
                          xi, inv_mass)

        q1, p1, lp1, _ = leapfrog(value_and_grad, state.params, p0, eps,
                                  inv_mass, n_leapfrog)
        h0 = -state.logpost + kinetic(p0, inv_mass)
        h1 = -lp1 + kinetic(p1, inv_mass)
        log_ratio = h0 - h1
        log_ratio = jnp.where(jnp.isfinite(log_ratio), log_ratio, -jnp.inf)
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        new_params = tree_where(accept, q1, state.params)
        new_lp = jnp.where(accept, lp1, state.logpost)
        info = {"accept_prob": accept_prob,
                "accepted": accept.astype(jnp.float32),
                "divergent": (log_ratio < -1000.0).astype(jnp.float32)}
        return MHState(params=new_params, logpost=new_lp), info

    return kernel


def dual_averaging_update(da: DualAveraging, accept_prob, t,
                          target: float = 0.8, gamma: float = 0.05,
                          t0: float = 10.0, kappa: float = 0.75):
    tt = t.astype(jnp.float32) + 1.0
    eta = 1.0 / (tt + t0)
    h_bar = (1.0 - eta) * da.h_bar + eta * (target - accept_prob)
    log_eps = da.mu - jnp.sqrt(tt) / gamma * h_bar
    w = tt ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * da.log_eps_bar
    return da.replace(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar)


def make_adapter(target_accept: float = 0.8,
                 mass_start: float = 100.0) -> Callable:
    """Warmup adapter: dual-averaging eps + diagonal mass from pooled
    position variance (engaged once the accumulator has mass_start
    samples)."""

    def adapt(hyper: HMCHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept)
        welford = welford_update_batch(hyper.welford, states.params, axis=0)
        n = welford.count
        ready = n > mass_start

        def im(m2, s):
            var = m2 / jnp.maximum(n - 1.0, 1.0)
            # s == 0 marks frozen coordinates (e.g. spike-slab indicators):
            # inverse mass stays 0 so leapfrog never moves them, even when
            # Gibbs flips give them nonzero pooled variance.
            return jnp.where(s > 0, jnp.where(ready, var + 1e-6 * s * s, s * s),
                             0.0)

        inv_mass = jax.tree.map(im, welford.m2, hyper.scales)
        return hyper.replace(da=da, welford=welford, inv_mass=inv_mass)

    return adapt


def finalize(hyper: HMCHyper) -> HMCHyper:
    """Post-warmup: switch to the averaged step size."""
    return hyper.replace(da=hyper.da.replace(log_eps=hyper.da.log_eps_bar))
