"""Generic MCMC runner: jit(scan(vmap(kernel))) with warmup adaptation,
online Welford moments, and thinned sample collection (SURVEY.md §3.1).

Structure of one hot-loop step (all on-chip):

  keys = split(key)                      # per-chain keys
  states, info = vmap(kernel)(keys, states, hyper)
  pooled = mean_over_chains(info)        # -> psum when chains are sharded
  hyper = adapt(hyper, pooled, states, t)   # warmup only
  welford = welford.update(track(states))   # sampling only
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.utils import pytree_dataclass, static_field
from mceik_tpu.diag.moments import Welford, welford_init, welford_update


@pytree_dataclass
class MHState:
    """Minimal Metropolis-family chain state."""

    params: Any
    logpost: jnp.ndarray


@pytree_dataclass
class MCMCResult:
    states: Any          # final chain-batched states
    hyper: Any           # final adaptation parameters
    welford: Welford     # per-chain online moments of track_fn output
    samples: Any         # thinned draws: (n_collect, n_chains, ...) pytree
    logpost_trace: jnp.ndarray   # (n_collect, n_chains)
    accept_trace: jnp.ndarray    # (n_collect, n_chains) mean accept prob
    warmup_accept: jnp.ndarray   # (n_warmup,) pooled accept prob
    n_steps: int = static_field(default=0)


def init_chain_states(logpost_fn, init_params_fn, key, n_chains: int) -> MHState:
    """Vmapped chain initialization from the model's init distribution."""
    keys = jax.random.split(key, n_chains)
    params = jax.vmap(init_params_fn)(keys)
    logpost = jax.vmap(logpost_fn)(params)
    return MHState(params=params, logpost=logpost)


def _one_step(kernel, states, hyper, key):
    n_chains = states.logpost.shape[0]
    keys = jax.random.split(key, n_chains)
    states, info = jax.vmap(kernel, in_axes=(0, 0, None))(keys, states, hyper)
    pooled = jax.tree.map(lambda x: jnp.mean(x, axis=0), info)
    return states, info, pooled


@partial(jax.jit, static_argnames=("kernel", "adapt_fn", "n_warmup", "n_steps",
                                   "thin", "track_fn", "finalize_fn",
                                   "collect_fn"))
def run_mcmc(
    kernel: Callable,
    adapt_fn: Optional[Callable],
    init_states: Any,
    init_hyper: Any,
    key: jnp.ndarray,
    n_warmup: int,
    n_steps: int,
    thin: int = 1,
    track_fn: Optional[Callable] = None,
    finalize_fn: Optional[Callable] = None,
    collect_fn: Optional[Callable] = None,
    init_welford: Optional[Welford] = None,
    t0_offset=0,  # TRACED (dynamic): a static offset would recompile the
                  # whole program once per warmup chunk when runs are
                  # chunked into short device executions.
) -> MCMCResult:
    """Run warmup (with adaptation) then sampling (with collection).

    kernel:      (key, state, hyper) -> (state, info); info must contain
                 "accept_prob" (per-chain scalar in [0, 1]).
    adapt_fn:    (hyper, pooled_info, states, t) -> hyper, or None.
    track_fn:    params -> pytree whose *online moments* are accumulated
                 every step (may include derived fields like the slowness
                 grid — no storage cost). Default: the params themselves.
    collect_fn:  params -> pytree *stored* every `thin` steps (keep small).
                 Default: track_fn.
    finalize_fn: hyper -> hyper applied once after warmup (e.g. switch to
                 the dual-averaged step size).
    t0_offset:   warmup-schedule time origin — pass the number of warmup
                 steps already taken when CHUNKING one logical warmup into
                 several calls (keeps Robbins-Monro / dual-averaging decay
                 schedules continuous across chunks).
    """
    if track_fn is None:
        track_fn = lambda p: p
    if collect_fn is None:
        collect_fn = track_fn

    def warmup_step(carry, t):
        states, hyper, k = carry
        k, sub = jax.random.split(k)
        states, _, pooled = _one_step(kernel, states, hyper, sub)
        if adapt_fn is not None:
            hyper = adapt_fn(hyper, pooled, states, t)
        return (states, hyper, k), pooled["accept_prob"]

    key, kw = jax.random.split(key)
    (states, hyper, _), warmup_accept = lax.scan(
        warmup_step, (init_states, init_hyper, kw),
        jnp.arange(n_warmup) + jnp.asarray(t0_offset, jnp.int32))
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)

    # Sampling: outer scan collects every `thin` steps; Welford sees every
    # step. Per-chain accumulators (leading chain axis). Segmented runs
    # (api.py checkpointing) pass the previous segment's accumulator in.
    n_chains = states.logpost.shape[0]
    if init_welford is not None:
        welford = init_welford
    else:
        tracked0 = jax.vmap(track_fn)(states.params)
        welford = welford_init(jax.tree.map(lambda x: x[0], tracked0),
                               batch_shape=(n_chains,))
    n_collect = n_steps // thin

    def inner_step(carry, _):
        states, welford, accept_sum, k = carry
        k, sub = jax.random.split(k)
        states, info, _ = _one_step(kernel, states, hyper, sub)
        welford = welford_update(welford, jax.vmap(track_fn)(states.params))
        return (states, welford, accept_sum + info["accept_prob"], k), None

    def outer_step(carry, _):
        states, welford, k = carry
        (states, welford, acc, k), _ = lax.scan(
            inner_step, (states, welford, jnp.zeros((n_chains,)), k),
            None, length=thin)
        draw = jax.vmap(collect_fn)(states.params)
        return (states, welford, k), (draw, states.logpost, acc / thin)

    (states, welford, _), (samples, logpost_trace, accept_trace) = lax.scan(
        outer_step, (states, welford, key), None, length=n_collect)

    return MCMCResult(
        states=states, hyper=hyper, welford=welford, samples=samples,
        logpost_trace=logpost_trace, accept_trace=accept_trace,
        warmup_accept=warmup_accept, n_steps=n_steps,
    )
