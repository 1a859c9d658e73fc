"""Random-walk Metropolis with Robbins-Monro step-size adaptation
(SURVEY.md §2.1 "RW-Metropolis"). Config 1's sampler.

Proposal: params' = params + exp(log_step) * scales * N(0, I), with
``scales`` a per-leaf pytree of natural parameter scales (from the prior)
and a single global log-step adapted toward the target acceptance rate
during warmup using cross-chain pooled acceptance (-> psum when sharded).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.samplers.base import MHState
from mceik_tpu.utils import tree_random_normal, tree_where


@pytree_dataclass
class RWMHyper:
    log_step: jnp.ndarray
    scales: Any  # pytree matching params


def init_hyper(scales: Any, step_size: float) -> RWMHyper:
    return RWMHyper(log_step=jnp.asarray(jnp.log(step_size), jnp.float32),
                    scales=scales)


def make_kernel(logpost_fn: Callable) -> Callable:
    def kernel(key, state: MHState, hyper: RWMHyper):
        k_prop, k_acc = jax.random.split(key)
        step = jnp.exp(hyper.log_step)
        eps = tree_random_normal(k_prop, state.params)
        prop = jax.tree.map(lambda p, e, s: p + step * s * e,
                            state.params, eps, hyper.scales)
        lp = logpost_fn(prop)
        log_ratio = lp - state.logpost
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        new_params = tree_where(accept, prop, state.params)
        new_lp = jnp.where(accept, lp, state.logpost)
        info = {"accept_prob": accept_prob,
                "accepted": accept.astype(jnp.float32)}
        return MHState(params=new_params, logpost=new_lp), info

    return kernel


def make_adapter(target_accept: float = 0.234, gamma0: float = 1.5,
                 t0: float = 3.0, kappa: float = 0.5) -> Callable:
    """Robbins-Monro log-step adaptation. The schedule must be strong
    enough to move log_step by O(5-10) within a warmup: cumulative
    capacity ~ gamma0 * err * 2*sqrt(T), so gamma0 ~ 1.5 handles even a
    1e-3x mis-specified initial step within a few hundred steps."""
    def adapt(hyper: RWMHyper, pooled, states, t):
        g = gamma0 / (t0 + t) ** kappa
        log_step = hyper.log_step + g * (pooled["accept_prob"] - target_accept)
        return hyper.replace(log_step=log_step)

    return adapt
