"""Full-covariance adaptive Metropolis (classic Haario et al. 2001) with
cross-chain pooled covariance (SURVEY.md §2.1 "Adaptive Metropolis" — the
reference's AM adapts the FULL proposal covariance from chain history; the
diagonal variant in am.py is the field-scale specialization where d^2
storage is infeasible).

For small/medium parameter counts (hypocenter sets, coarse inversion
bases, noise hyperparameters — up to a few thousand dims) the full
covariance captures the strong cross-cell correlations a tomography
posterior always has (smooth prior + path-integral data), which is exactly
where diagonal AM's mixing collapses (measured: per-cell autocorrelation
time > 2000 steps on a 27-dim 3-D problem that full-cov AM mixes in tens).

Design notes:
  - The proposal works on the FLATTENED parameter vector; pytree structure
    is (un)raveled once per step (cheap at these sizes).
  - Pooled covariance: one Welford accumulator over all chains x steps
    (cross-chain pooling = the psum'd adaptation statistic of SURVEY.md
    §2.4 when chains are sharded).
  - The Cholesky factor is refreshed every step from the running
    covariance (d <= ~2k: a d^2/d^3 op that amortizes to noise next to
    the eikonal solves); Haario regularization eps*I keeps it SPD during
    the early phase.
  - Frozen coordinates (prior scale 0, e.g. spike-slab indicators) keep
    zero proposal variance: rows/cols of the covariance are masked.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.samplers.base import MHState
from mceik_tpu.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu.utils import tree_where

# float32 products: a TF32 default on the GPU would keep ~3 digits.
HIGHEST = lax.Precision.HIGHEST


@pytree_dataclass
class AMFullHyper:
    log_step: jnp.ndarray
    count: jnp.ndarray       # pooled sample count
    mean: jnp.ndarray        # (d,) running mean
    m2: jnp.ndarray          # (d, d) running scatter (sum of outer prods)
    scales_flat: jnp.ndarray  # (d,) prior scales; 0 marks frozen coords
    reg: jnp.ndarray
    da: DualAveraging        # dual-averaging state for the step tuner


def _ravel(params) -> jnp.ndarray:
    return jnp.concatenate([jnp.ravel(x) for x in jax.tree.leaves(params)])


def _unravel_fn(example):
    leaves, treedef = jax.tree.flatten(example)
    sizes = [x.size for x in leaves]
    shapes = [x.shape for x in leaves]

    def unravel(v):
        out, off = [], 0
        for size, shape in zip(sizes, shapes):
            out.append(v[off:off + size].reshape(shape))
            off += size
        return jax.tree.unflatten(treedef, out)

    return unravel


def init_hyper(scales: Any, step_size: float, example_params: Any,
               reg: float = 1e-6) -> AMFullHyper:
    sf = _ravel(scales)
    d = sf.shape[0]
    log_eps = jnp.asarray(jnp.log(step_size), jnp.float32)
    return AMFullHyper(
        log_step=log_eps,
        count=jnp.asarray(0.0, jnp.float32),
        mean=jnp.zeros((d,), jnp.float32),
        m2=jnp.zeros((d, d), jnp.float32),
        scales_flat=sf.astype(jnp.float32),
        reg=jnp.asarray(reg, jnp.float32),
        da=DualAveraging(mu=log_eps, log_eps=log_eps, log_eps_bar=log_eps,
                         h_bar=jnp.asarray(0.0, jnp.float32)),
    )


def _proposal_chol(hyper: AMFullHyper):
    """Cholesky of the (regularized, masked) pooled covariance; prior
    scales until the accumulator has enough mass."""
    d = hyper.scales_flat.shape[0]
    n = hyper.count
    ready = n > 2.0 * d
    active = (hyper.scales_flat > 0).astype(jnp.float32)
    cov = hyper.m2 / jnp.maximum(n - 1.0, 1.0)
    floor = (hyper.reg + 1e-4) * hyper.scales_flat ** 2
    cov = cov * active[:, None] * active[None, :] + jnp.diag(floor)
    prior_cov = jnp.diag(hyper.scales_flat ** 2)
    cov = jnp.where(ready, cov, prior_cov)
    # 0-variance (frozen) coords: give the diag a dummy 1 so chol succeeds,
    # then zero those columns of L (no proposal component).
    covd = cov + jnp.diag(1.0 - active)
    L = jnp.linalg.cholesky(covd)
    return L * active[None, :] * active[:, None]


def make_kernel(logpost_fn: Callable) -> Callable:
    def kernel(key, state: MHState, hyper: AMFullHyper):
        k_prop, k_acc = jax.random.split(key)
        unravel = _unravel_fn(state.params)
        x = _ravel(state.params)
        d_active = jnp.sum((hyper.scales_flat > 0).astype(jnp.float32))
        step = jnp.exp(hyper.log_step) * 2.38 / jnp.sqrt(
            jnp.maximum(d_active, 1.0))
        L = _proposal_chol(hyper)
        eps = jax.random.normal(k_prop, x.shape, x.dtype)
        prop = unravel(x + step * jnp.matmul(L, eps, precision=HIGHEST))
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


def make_adapter(target_accept: float = 0.234) -> Callable:
    """Dual-averaging step tuner (see am.make_adapter's rationale — RM's
    proportional control converges too slowly when the start is e-folds
    off) + pooled full-covariance Welford."""

    def adapt(hyper: AMFullHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        # Batch Welford merge of all chains' positions into the pooled
        # full-covariance accumulator.
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
        return hyper.replace(log_step=da.log_eps, da=da, count=n, mean=mean,
                             m2=m2)

    return adapt


def finalize(hyper: AMFullHyper) -> AMFullHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate."""
    return hyper.replace(log_step=hyper.da.log_eps_bar)
