"""Preconditioned Metropolis-adjusted Langevin (MALA) with the full
Haario covariance as preconditioner (VERDICT r2 next-step #2: a
gradient kernel that pays ONE gradient per step and moves the soft
directions of the strongly-correlated tomography posterior, where
diagonal-mass HMC/NUTS sit at the per-cell ESS estimator floor and
diagonal AM's autocorrelation time exceeds any bench window).

Proposal (C = L L^T the learned covariance, eps the adapted step):

    y = x + (eps^2 / 2) C grad(x) + eps L xi ,   xi ~ N(0, I)

with the exact MH correction for the asymmetric kernel. Formulation: everything happens in the WHITENED space so no triangular
solve is ever needed — with a = L^T grad(x), a_y = L^T grad(y):

    y               = x + L (eps^2/2 a + eps xi)          (one matmul)
    L^{-1}(x - y - eps^2/2 C grad(y)) / eps
                    = -xi - eps/2 (a + a_y)               (no solve)

so the Hastings ratio is ||xi||^2/2 - ||xi + eps/2 (a + a_y)||^2/2 plus
the logpost difference — two (d,d)@(d,) matmuls per gradient, small next
to the gradient itself (a forward eikonal solve plus its adjoint). The gradient at the
current point is CACHED in the chain state (MALAState.grad), so each
step pays exactly one new value_and_grad.

Adaptation: dual averaging on log eps toward the MALA-optimal 0.574
acceptance (integral control — see am.make_adapter's rationale); pooled cross-chain full-covariance Welford (shared with
am_full's AMFullHyper — the psum'd adaptation statistic of SURVEY.md
§2.4 when chains are sharded), with exponential forgetting so the
burn-in transient flushes (same rationale as am.make_adapter).

Frozen coordinates (prior scale 0, e.g. spike-slab indicators moved only
by Gibbs): their gradient and noise components are masked to zero, and
the covariance construction (am_full._proposal_cov_dense) gives them
unit diagonal / zero cross terms, so the kernel provably never moves
them and the whitened identities above stay exact.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.samplers.am_full import (AMFullHyper, _ravel, _unravel_fn,
                                        init_hyper as _am_full_init_hyper)
from mceik_tpu.utils import tree_where

# float32 products: a TF32 default on the GPU would keep ~3 digits.
HIGHEST = lax.Precision.HIGHEST


@pytree_dataclass
class MALAState:
    """MH chain state + cached gradient at the current point."""

    params: Any
    logpost: jnp.ndarray
    grad: Any            # pytree like params


def init_hyper(scales: Any, step_size: float, example_params: Any,
               reg: float = 1e-6) -> AMFullHyper:
    """Same accumulator as full-covariance AM; log_step here is log(eps)
    directly (no 2.38/sqrt(d) RWM scaling — Langevin steps live on the
    eps ~ d^{-1/6} scale and the adapter owns the magnitude)."""
    return _am_full_init_hyper(scales, step_size, example_params, reg=reg)


def init_states(logpost_fn: Callable, init_params_fn: Callable, key,
                n_chains: int) -> MALAState:
    """Vmapped chain init with gradients (logpost_fn must be built with
    differentiable=True)."""
    vag = jax.value_and_grad(logpost_fn)
    keys = jax.random.split(key, n_chains)
    params = jax.vmap(init_params_fn)(keys)
    logpost, grad = jax.vmap(vag)(params)
    return MALAState(params=params, logpost=logpost, grad=grad)


def from_mh_states(logpost_fn: Callable, states) -> MALAState:
    """Lift plain MHState chains (e.g. the tail of an AM warmup used to
    learn the preconditioner) into MALA states by evaluating gradients."""
    vag = jax.value_and_grad(logpost_fn)
    logpost, grad = jax.vmap(vag)(states.params)
    return MALAState(params=states.params, logpost=logpost, grad=grad)


def _chol_unmasked(hyper: AMFullHyper) -> jnp.ndarray:
    """Cholesky of the regularized pooled covariance with UNIT diagonal at
    frozen coordinates (vs am_full._proposal_chol which zero-masks them:
    MALA's whitened algebra needs L invertible; masking the noise and
    gradient instead keeps frozen coords exactly still)."""
    d = hyper.scales_flat.shape[0]
    n = hyper.count
    ready = n > 2.0 * d
    active = (hyper.scales_flat > 0).astype(jnp.float32)
    cov = hyper.m2 / jnp.maximum(n - 1.0, 1.0)
    floor = (hyper.reg + 1e-4) * hyper.scales_flat ** 2
    cov = cov * active[:, None] * active[None, :] + jnp.diag(floor)
    prior_cov = jnp.diag(hyper.scales_flat ** 2)
    cov = jnp.where(ready, cov, prior_cov)
    covd = cov + jnp.diag(1.0 - active)
    return jnp.linalg.cholesky(covd)


def make_kernel(logpost_fn: Callable) -> Callable:
    """MALA transition kernel: (key, MALAState, AMFullHyper) -> state, info."""
    vag = jax.value_and_grad(logpost_fn)

    def kernel(key, state: MALAState, hyper: AMFullHyper):
        k_prop, k_acc = jax.random.split(key)
        unravel = _unravel_fn(state.params)
        x = _ravel(state.params)
        active = hyper.scales_flat > 0
        g = jnp.where(active, _ravel(state.grad), 0.0)
        eps = jnp.exp(hyper.log_step)
        L = _chol_unmasked(hyper)

        a = jnp.matmul(L.T, g, precision=HIGHEST)
        xi = jnp.where(active,
                       jax.random.normal(k_prop, x.shape, x.dtype), 0.0)
        y = x + jnp.matmul(L, 0.5 * eps * eps * a + eps * xi,
                           precision=HIGHEST)

        prop = unravel(y)
        lp_y, grad_y = vag(prop)
        ay = jnp.matmul(L.T, jnp.where(active, _ravel(grad_y), 0.0),
                        precision=HIGHEST)

        # Whitened reverse residual (see module docstring): no solve.
        z = xi + 0.5 * eps * (a + ay)
        log_ratio = (lp_y - state.logpost
                     + 0.5 * jnp.sum(xi * xi) - 0.5 * jnp.sum(z * z))
        log_ratio = jnp.where(jnp.isfinite(log_ratio), log_ratio, -jnp.inf)
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept = jnp.log(jax.random.uniform(k_acc)) < log_ratio

        new_params = tree_where(accept, prop, state.params)
        new_grad = tree_where(accept, grad_y, state.grad)
        new_lp = jnp.where(accept, lp_y, state.logpost)
        info = {"accept_prob": accept_prob,
                "accepted": accept.astype(jnp.float32),
                "divergent": (log_ratio < -1000.0).astype(jnp.float32)}
        return MALAState(params=new_params, logpost=new_lp,
                         grad=new_grad), info

    return kernel


def make_adapter(target_accept: float = 0.574,
                 mem_samples: float = 5000.0,
                 adapt_cov: bool = True) -> Callable:
    """Warmup adapter: dual-averaging step tuner toward the
    Langevin-optimal acceptance (see am.make_adapter's rationale — RM's
    proportional control froze mid-collapse at short warmups, the r4
    'init-transient rejections drive eps 0.3 -> 0.029' row) + pooled
    full-covariance Welford with exponential forgetting (effective count
    capped at mem_samples so the burn-in transient flushes instead of
    pinning the shape forever).

    ``adapt_cov=False`` tunes ONLY the step size — required when the
    covariance was pinned via :func:`prime_covariance` (e.g. the Laplace
    / Gauss-Newton preconditioner, model/laplace.py): the forgetting
    cap would otherwise crush the pinned count on the first step and let
    overdispersed burn-in positions corrupt the preconditioner (measured:
    eps driven 1.0 -> 0.27 and per-cell ESS 200 -> 12 on an 11^3 tomo
    problem)."""
    from mceik_tpu.samplers.hmc import dual_averaging_update

    def adapt(hyper: AMFullHyper, pooled, states: MALAState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        log_step = da.log_eps
        if not adapt_cov:
            return hyper.replace(log_step=log_step, da=da)
        X = jax.vmap(_ravel)(states.params)            # (C, d)
        C = X.shape[0]
        n0, mean0, m20 = hyper.count, hyper.mean, hyper.m2
        bmean = jnp.mean(X, axis=0)
        Xc = X - bmean[None, :]
        bm2 = jnp.matmul(Xc.T, Xc, precision=HIGHEST)
        n = n0 + C
        delta = bmean - mean0
        mean = mean0 + delta * (C / jnp.maximum(n, 1.0))
        m2 = m20 + bm2 + jnp.outer(delta, delta) * (n0 * C / jnp.maximum(n, 1.0))
        f = jnp.minimum(1.0, mem_samples / jnp.maximum(n, 1.0))
        return hyper.replace(log_step=log_step, da=da, count=n * f,
                             mean=mean, m2=m2 * f)

    return adapt


def finalize(hyper: AMFullHyper) -> AMFullHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate."""
    return hyper.replace(log_step=hyper.da.log_eps_bar)


def prime_covariance(hyper: AMFullHyper, cov, n_prime: float = 1e6,
                     log_step=None) -> AMFullHyper:
    """Pin a learned covariance (e.g. from an am/am_full warmup or a
    previous run's sample covariance) as the preconditioner; adaptation
    can then only retune the global step."""
    cov = jnp.asarray(cov, jnp.float32)
    h = hyper.replace(count=jnp.asarray(n_prime, jnp.float32),
                      m2=(n_prime - 1.0) * cov)
    if log_step is not None:
        h = h.replace(log_step=jnp.asarray(log_step, jnp.float32))
    return h
