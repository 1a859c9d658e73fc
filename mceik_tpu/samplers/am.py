"""Adaptive Metropolis (SURVEY.md §2.1 "Adaptive Metropolis"): Haario-style
proposal adaptation from chain history, pooled across chains. Config 2's
sampler.

For field-scale parameters (a 64^3 slowness field) the classic full
proposal covariance is infeasible (d^2 entries), so this design
adapts a *diagonal* covariance online — per-coordinate posterior variances
estimated with a cross-chain+time Welford accumulator (the cross-chain
merge is exactly the collective-pooled adaptation of SURVEY.md §3.1) — plus
the usual global scale 2.38/sqrt(d) with dual-averaging acceptance tuning
(see make_adapter).

Optionally the field block uses a pCN (preconditioned Crank-Nicolson)
proposal, which is well-posed in the infinite-dimensional Gaussian-prior
limit and keeps acceptance dimension-robust.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.diag.moments import Welford, welford_init, welford_update_batch
from mceik_tpu.samplers.base import MHState
from mceik_tpu.samplers.hmc import DualAveraging, dual_averaging_update
from mceik_tpu.utils import tree_random_normal, tree_size, tree_where


@pytree_dataclass
class AMHyper:
    log_step: jnp.ndarray
    scales: Any          # prior-based fallback scales (pytree like params)
    welford: Welford     # pooled running moments of the chain positions
    reg: jnp.ndarray     # regularization floor on the adapted std
    da: DualAveraging    # dual-averaging state for the step tuner


def _init_da(step_size: float) -> DualAveraging:
    log_eps = jnp.asarray(jnp.log(step_size), jnp.float32)
    return DualAveraging(mu=log_eps, log_eps=log_eps, log_eps_bar=log_eps,
                         h_bar=jnp.asarray(0.0, jnp.float32))


def init_hyper(scales: Any, step_size: float, example_params: Any,
               reg: float = 1e-3) -> AMHyper:
    return AMHyper(
        log_step=jnp.asarray(jnp.log(step_size), jnp.float32),
        scales=scales,
        welford=welford_init(example_params),
        reg=jnp.asarray(reg, jnp.float32),
        da=_init_da(step_size),
    )


def _proposal_std(hyper: AMHyper):
    """Blend adapted per-coordinate std with prior scales until the
    accumulator has enough mass (Haario's initial phase).

    The adapted std is NORMALIZED to the prior scales' geometric mean over
    active coordinates: the welford only reshapes the proposal, while the
    global magnitude is owned entirely by ``log_step``. Without this the
    Robbins-Monro step tuner chases a moving target (the accumulating
    variance estimate keeps rescaling the proposal under it) and longer
    warmups END UP at *worse* acceptance — measured 0.084 after 300 warmup
    steps at inv=12^3 vs 0.4 after 50 (BASELINE.md 2026-08-19 r2 caveat;
    VERDICT r2 #5)."""
    n = hyper.welford.count
    ready = n > 50.0

    def std_leaf(m2, scale):
        var = m2 / jnp.maximum(n - 1.0, 1.0)
        adapted = jnp.sqrt(var + (hyper.reg * scale) ** 2)
        # scale == 0 marks frozen coordinates (spike-slab indicators moved
        # only by Gibbs): adaptation must never thaw them even though the
        # Gibbs flips give them cross-chain variance.
        return jnp.where(scale > 0, adapted, 0.0)

    raw = jax.tree.map(std_leaf, hyper.welford.m2, hyper.scales)

    # log geometric-mean correction over ALL active coords of the pytree.
    def logsum_leaf(st, sc):
        active = sc > 0
        return (jnp.sum(jnp.where(active, jnp.log(jnp.maximum(st, 1e-30))
                                  - jnp.log(jnp.where(active, sc, 1.0)), 0.0)),
                jnp.sum(active.astype(jnp.float32)))

    parts = [logsum_leaf(st, sc) for st, sc in
             zip(jax.tree.leaves(raw), jax.tree.leaves(hyper.scales))]
    tot = sum(p[0] for p in parts)
    cnt = sum(p[1] for p in parts)
    c = jnp.exp(-tot / jnp.maximum(cnt, 1.0))

    return jax.tree.map(
        lambda st, sc: jnp.where(sc > 0, jnp.where(ready, c * st, sc), 0.0),
        raw, hyper.scales)


def make_kernel(logpost_fn: Callable) -> Callable:
    def kernel(key, state: MHState, hyper: AMHyper):
        k_prop, k_acc = jax.random.split(key)
        d = tree_size(state.params)
        step = jnp.exp(hyper.log_step) * 2.38 / jnp.sqrt(jnp.asarray(float(d)))
        std = _proposal_std(hyper)
        eps = tree_random_normal(k_prop, state.params)
        prop = jax.tree.map(lambda p, e, s: p + step * s * e,
                            state.params, eps, std)
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


def make_adapter(target_accept: float = 0.234,
                 mem_samples: float = 2000.0) -> Callable:
    """Warmup adapter. ``mem_samples`` caps the Welford's effective count
    (exponential forgetting): without it the variance estimate keeps the
    init/burn-in transient forever, inflating the proposal shape no matter
    how long warmup runs (the other half of the r2 overshoot — see
    _proposal_std). ~2000 chain-positions is ≈125 steps of memory at 16
    chains: long enough for a stable shape, short enough to flush the
    transient within a few hundred warmup steps.

    Step tuning is DUAL AVERAGING on the pooled acceptance (shared with
    HMC's tuner), not Robbins-Monro: RM's proportional control with a
    decaying gain needs |log-step travel| / |acceptance error| steps to
    converge — measured in the THOUSANDS when the start is a couple of
    e-folds off (tools/rm_probe.py; the r2/r4 'adaptation overshoot'
    rows: accept 0.084 after 300 warmup steps, 0.144 after 60). DA's
    integral action keeps pushing while the error has a consistent sign,
    landing any warmup length >= ~30 steps inside [0.15, 0.35] at
    flagship dimension (tests/test_samplers.py warmup-stability test)."""

    def adapt(hyper: AMHyper, pooled, states: MHState, t):
        da = dual_averaging_update(hyper.da, pooled["accept_prob"], t,
                                   target=target_accept, gamma=0.1, t0=20.0)
        # Feed every chain's current position into the pooled covariance
        # estimate (batch Welford merge; cross-device this is the psum'd
        # adaptation statistic of SURVEY.md §2.4).
        welford = welford_update_batch(hyper.welford, states.params, axis=0)
        f = jnp.minimum(1.0, mem_samples / jnp.maximum(welford.count, 1.0))
        welford = welford.replace(
            count=welford.count * f,
            m2=jax.tree.map(lambda m: m * f, welford.m2))
        return hyper.replace(log_step=da.log_eps, da=da, welford=welford)

    return adapt


def finalize(hyper: AMHyper) -> AMHyper:
    """Post-warmup: freeze the step at the dual-averaged iterate (less
    noisy than the last primal iterate)."""
    return hyper.replace(log_step=hyper.da.log_eps_bar)
