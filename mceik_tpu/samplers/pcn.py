"""Preconditioned Crank-Nicolson (pCN) Metropolis (SURVEY.md §2.1
"Adaptive Metropolis" upgrade).

For Gaussian-prior parameter blocks the pCN proposal

    theta' = sqrt(1 - rho^2) * theta + rho * sigma_prior * xi

is prior-reversible, so the acceptance ratio uses the LIKELIHOOD alone —
well-posed in the infinite-dimensional limit, which makes acceptance
dimension-robust for field parameters (a 64^3 slowness field) where plain
RW acceptance collapses. Non-Gaussian blocks (hypocenters' logistic-prior
``hypo_raw``) get a symmetric random walk whose prior ratio enters the
acceptance explicitly. rho's logit is dual-averaging adapted toward
0.234 via cross-chain pooled acceptance — the same integral-action tuner
as am/am_full/mala (VERDICT r4 #6: Robbins-Monro's proportional control
needs thousands of steps when the start is e-folds off target).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.samplers.base import MHState
from mceik_tpu.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu.utils import tree_random_normal, tree_where


@pytree_dataclass
class PCNHyper:
    log_rho: jnp.ndarray      # pCN step (maps through sigmoid to (0,1))
    gauss_scales: Any         # prior sigmas for Gaussian leaves (None = RW)
    rw_scales: Any            # scales for non-Gaussian leaves (None = pCN)
    da: DualAveraging         # dual-averaging state on logit(rho)


def init_hyper(gauss_scales: Any, rw_scales: Any, rho: float = 0.1) -> PCNHyper:
    rho = min(max(rho, 1e-4), 0.999)
    lr = jnp.asarray(jnp.log(rho / (1 - rho)), jnp.float32)
    return PCNHyper(
        log_rho=lr, gauss_scales=gauss_scales, rw_scales=rw_scales,
        da=DualAveraging(mu=lr, log_eps=lr, log_eps_bar=lr,
                         h_bar=jnp.asarray(0.0, jnp.float32)))


def make_kernel(log_lik_fn: Callable,
                log_prior_nongauss_fn: Optional[Callable] = None) -> Callable:
    """pCN-within-MH transition.

    log_lik_fn: likelihood alone (the Gaussian prior is absorbed by the
      proposal). log_prior_nongauss_fn: prior of the RW-proposed leaves
      (e.g. logistic hypo_raw terms); None if all leaves are Gaussian.

    The chain state's ``logpost`` field stores loglik + nongauss prior
    (the Gaussian prior term is intentionally absent — it cancels).
    """

    def kernel(key, state: MHState, hyper: PCNHyper):
        k_prop, k_acc = jax.random.split(key)
        rho = jax.nn.sigmoid(hyper.log_rho)
        eps = tree_random_normal(k_prop, state.params)

        def propose(p, e, gs, rs):
            # None params leaves (inactive blocks: t0/log_sigma/hypo_raw
            # in plain-tomo mode) pass through — is_leaf=None-check makes
            # them leaves of every input tree, so they reach this fn.
            if p is None:
                return None
            if gs is not None:
                return jnp.sqrt(1.0 - rho * rho) * p + rho * gs * e
            if rs is not None:
                return p + rho * rs * e
            return p

        prop = jax.tree.map(
            propose, state.params, eps, hyper.gauss_scales, hyper.rw_scales,
            is_leaf=lambda x: x is None)
        ll = log_lik_fn(prop)
        if log_prior_nongauss_fn is not None:
            ll = ll + log_prior_nongauss_fn(prop)
        log_ratio = ll - state.logpost
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio
        new_params = tree_where(accept, prop, state.params)
        new_lp = jnp.where(accept, ll, state.logpost)
        info = {"accept_prob": accept_prob,
                "accepted": accept.astype(jnp.float32)}
        return MHState(params=new_params, logpost=new_lp), info

    return kernel


def make_adapter(target_accept: float = 0.234) -> Callable:
    """Warmup adapter: dual averaging on logit(rho) (see am.make_adapter's
    rationale for DA over Robbins-Monro)."""

    def adapt(hyper: PCNHyper, pooled, states, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        return hyper.replace(log_rho=da.log_eps, da=da)

    return adapt


def finalize(hyper: PCNHyper) -> PCNHyper:
    """Post-warmup: freeze rho at the dual-averaged iterate."""
    return hyper.replace(
        log_rho=hyper.da.log_eps_bar,
        da=hyper.da.replace(log_eps=hyper.da.log_eps_bar))


def init_state(log_lik_fn: Callable, params,
               log_prior_nongauss_fn: Optional[Callable] = None) -> MHState:
    lp = log_lik_fn(params)
    if log_prior_nongauss_fn is not None:
        lp = lp + log_prior_nongauss_fn(params)
    return MHState(params=params, logpost=lp)
