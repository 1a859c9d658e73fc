"""Tempered-likelihood Sequential Monte Carlo (SURVEY.md §2.1 "SMC", §3.4;
config 4).

Structure: particles start as exact prior draws; the inverse temperature
beta climbs 0 -> 1 on an *adaptive* ladder (each increment chosen by
bisection so the incremental weights keep ESS at ``ess_threshold * N``);
each stage reweights, systematically resamples (dist/resample.py — index
computation replicated, exchange via sharded gather), and rejuvenates with
K random-walk Metropolis steps targeting the tempered posterior
``log_prior + beta * log_lik``, whose proposal scale is Robbins-Monro
adapted from the pooled acceptance across all particles.

The temperature ladder lives in a host-side Python loop (its length is
data-dependent); everything inside a stage is jitted with ``beta`` traced,
so no stage ever recompiles. Accumulates the log-evidence estimate
``log Z = sum_t logmeanexp(incremental log-weights)`` for free.

Distribution (config 4, "10k particles sharded across chips"): pass a
``mesh`` — particles shard over its axis, every stage jit carries explicit
``out_shardings`` so the systematic-resample gather and the mutation keep
the population sharded; the ESS/logZ/pooled-acceptance scalars are global
reductions XLA lowers to all-reduces. Checkpoint/resume (SURVEY.md §5
"checkpoints are complete"): ``checkpoint_path`` persists the full
population + ladder position + loop PRNG key after every stage, and
``resume`` continues a killed run to a bit-identical result.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Any, Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from mceik_tpu.utils import pytree_dataclass
from mceik_tpu.dist.resample import (ess_from_log_weights, resample_tree,
                                     systematic_indices)
from mceik_tpu.utils import tree_random_normal, tree_where


@pytree_dataclass
class SMCState:
    params: Any                 # particle-batched pytree
    log_prior: jnp.ndarray      # (N,)
    log_lik: jnp.ndarray        # (N,)
    log_step: jnp.ndarray       # mutation proposal log-scale (shared)


@dataclasses.dataclass
class SMCResult:
    state: SMCState
    betas: List[float]
    ess_history: List[float]
    accept_history: List[float]
    log_evidence: float
    n_stages: int


def init_particles(posterior, key, n_particles: int,
                   step_size: float = 0.1) -> SMCState:
    keys = jax.random.split(key, n_particles)
    params = jax.vmap(posterior.sample_prior)(keys)
    lp = jax.vmap(posterior.log_prior)(params)
    ll = jax.vmap(posterior.log_lik)(params)
    return SMCState(params=params, log_prior=lp, log_lik=ll,
                    log_step=jnp.asarray(np.log(step_size), jnp.float32))


def _mutate_impl(state: SMCState, beta, key, scales, log_prior_fn, log_lik_fn,
                 n_steps: int, target_accept: float = 0.234, gibbs_fn=None):
    """K tempered-RWM steps over all particles; adapts the shared proposal
    scale from pooled acceptance between steps. ``gibbs_fn`` (the
    posterior's trans-dimensional noise sweep, tempered by ``beta``) runs
    once per mutation step so indicator moves mix inside SMC too."""
    n = state.log_lik.shape[0]

    def one_step(carry, k):
        params, lp_prior, lp_lik, log_step = carry
        k1, k2 = jax.random.split(k)
        step = jnp.exp(log_step)

        def propose(key_i, p):
            eps = tree_random_normal(key_i, p)
            return jax.tree.map(lambda x, e, s: x + step * s * e, p, eps, scales)

        keys_p = jax.random.split(k1, n)
        prop = jax.vmap(propose)(keys_p, params)
        prop_prior = jax.vmap(log_prior_fn)(prop)
        prop_lik = jax.vmap(log_lik_fn)(prop)
        log_ratio = (prop_prior + beta * prop_lik) - (lp_prior + beta * lp_lik)
        accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
        accept = jnp.log(jax.random.uniform(k2, (n,))) < log_ratio
        params = jax.tree.map(
            lambda a, b: jnp.where(
                accept.reshape((n,) + (1,) * (a.ndim - 1)), a, b), prop, params)
        lp_prior = jnp.where(accept, prop_prior, lp_prior)
        lp_lik = jnp.where(accept, prop_lik, lp_lik)
        if gibbs_fn is not None:
            keys_g = jax.random.split(jax.random.fold_in(k2, 1), n)
            params, lp_prior, lp_lik = jax.vmap(
                lambda kk, pp: gibbs_fn(kk, pp, beta))(keys_g, params)
        # Pooled (cross-particle -> cross-device) acceptance adaptation.
        pooled = jnp.mean(accept_prob)
        log_step = log_step + 0.3 * (pooled - target_accept)
        return (params, lp_prior, lp_lik, log_step), pooled

    keys = jax.random.split(key, n_steps)
    (params, lp_prior, lp_lik, log_step), accepts = lax.scan(
        one_step, (state.params, state.log_prior, state.log_lik,
                   state.log_step), keys)
    return SMCState(params=params, log_prior=lp_prior, log_lik=lp_lik,
                    log_step=log_step), jnp.mean(accepts)


@jax.jit
def _ess_at(log_lik, beta_prev, beta):
    return ess_from_log_weights((beta - beta_prev) * log_lik)


def _reweight_resample_impl(state: SMCState, beta_prev, beta, key):
    lw = (beta - beta_prev) * state.log_lik
    log_inc = jax.scipy.special.logsumexp(lw) - jnp.log(lw.shape[0])
    idx = systematic_indices(key, lw)
    params = resample_tree(state.params, idx)
    return SMCState(params=params,
                    log_prior=jnp.take(state.log_prior, idx),
                    log_lik=jnp.take(state.log_lik, idx),
                    log_step=state.log_step), log_inc


_mutate = partial(jax.jit, static_argnames=(
    "log_prior_fn", "log_lik_fn", "n_steps", "gibbs_fn"))(_mutate_impl)
_reweight_resample = jax.jit(_reweight_resample_impl)


def _state_shardings(state: SMCState, mesh: Mesh, axis: str):
    """NamedSharding pytree: particle axis sharded, scalars replicated."""
    def spec(x):
        if x.ndim >= 1 and x.shape[0] % mesh.devices.size == 0:
            return NamedSharding(
                mesh, PartitionSpec(axis, *([None] * (x.ndim - 1))))
        return NamedSharding(mesh, PartitionSpec())
    return jax.tree.map(spec, state)


@functools.lru_cache(maxsize=32)
def _sharded_stage_fns(mesh: Mesh, axis: str, log_prior_fn, log_lik_fn,
                       n_steps: int, state_treedef, state_shapes,
                       gibbs_fn=None):
    """Stage jits with explicit out_shardings so the population stays
    sharded through the resample gather and the mutation scan.

    Cached per (mesh, model fns, population shape) so repeated run_smc
    calls (segmented ladders, resume) never re-trace.
    """
    example = jax.tree_util.tree_unflatten(
        state_treedef,
        [jax.ShapeDtypeStruct(s, d) for s, d in state_shapes])
    sh = _state_shardings(example, mesh, axis)
    scalar = NamedSharding(mesh, PartitionSpec())
    reweight = jax.jit(_reweight_resample_impl, out_shardings=(sh, scalar))
    mutate = partial(
        jax.jit(_mutate_impl,
                static_argnames=("log_prior_fn", "log_lik_fn", "n_steps",
                                 "gibbs_fn"),
                out_shardings=(sh, scalar)),
        log_prior_fn=log_prior_fn, log_lik_fn=log_lik_fn, n_steps=n_steps,
        gibbs_fn=gibbs_fn)
    return reweight, mutate


def next_beta(log_lik, beta_prev: float, target_ess: float,
              n_bisect: int = 30) -> float:
    """Largest beta <= 1 whose incremental weights keep ESS >= target."""
    if float(_ess_at(log_lik, beta_prev, 1.0)) >= target_ess:
        return 1.0
    lo, hi = beta_prev, 1.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        if float(_ess_at(log_lik, beta_prev, mid)) >= target_ess:
            lo = mid
        else:
            hi = mid
    return max(lo, beta_prev + 1e-6)


def run_smc(posterior, key, n_particles: int, n_mutation_steps: int = 5,
            ess_threshold: float = 0.5, step_size: float = 0.1,
            max_stages: int = 200, verbose: bool = False,
            mesh: Optional[Mesh] = None, shard_axis: str = "chains",
            checkpoint_path: Optional[str] = None,
            resume: Optional[str] = None) -> SMCResult:
    """Full tempered SMC run: prior -> posterior.

    mesh:            particles shard over its (single) axis; stage jits pin
                     out_shardings so the population never gathers to one
                     device (config 4's "10k particles sharded across
                     chips").
    checkpoint_path: atomically persist (population, loop key) + ladder
                     metadata after every stage.
    resume:          continue a previous run from its checkpoint — the
                     completed ladder replays exactly (the stored loop key
                     makes stage s of the resumed run identical to stage s
                     of an uninterrupted one).
    """
    from mceik_tpu.dist.mesh import shard_chains

    k_init, k_loop = jax.random.split(jnp.asarray(key))
    state = init_particles(posterior, k_init, n_particles, step_size)

    betas, ess_hist, acc_hist = [0.0], [float(n_particles)], []
    log_z, beta, stage = 0.0, 0.0, 0

    if resume:
        from mceik_tpu.io.checkpoint import load_checkpoint
        (state, k_loop), meta = load_checkpoint(resume, (state, k_loop))
        betas = list(meta["betas"])
        ess_hist = list(meta["ess_history"])
        acc_hist = list(meta["accept_history"])
        log_z, beta, stage = meta["log_z"], betas[-1], meta["stage"]
        if verbose:
            print(f"[smc] resumed stage={stage} beta={beta:.4f} "
                  f"logZ={log_z:.2f} from {resume}")

    gibbs_fn = getattr(posterior, "noise_gibbs", None)
    sharded = mesh is not None and mesh.devices.size > 1
    if sharded:
        if n_particles % mesh.devices.size:
            raise ValueError(
                f"n_particles={n_particles} not divisible by "
                f"{mesh.devices.size} devices")
        state = shard_chains(state, mesh, shard_axis)
        flat, treedef = jax.tree_util.tree_flatten(state)
        shapes = tuple((tuple(x.shape), jnp.asarray(x).dtype) for x in flat)
        reweight, mutate = _sharded_stage_fns(
            mesh, shard_axis, posterior.log_prior, posterior.log_lik,
            n_mutation_steps, treedef, shapes, gibbs_fn)
    else:
        reweight = _reweight_resample
        mutate = partial(_mutate, log_prior_fn=posterior.log_prior,
                         log_lik_fn=posterior.log_lik,
                         n_steps=n_mutation_steps, gibbs_fn=gibbs_fn)

    target_ess = ess_threshold * n_particles
    while beta < 1.0 and stage < max_stages:
        k_loop, k_rs, k_mut = jax.random.split(k_loop, 3)
        beta_new = next_beta(state.log_lik, beta, target_ess)
        ess = float(_ess_at(state.log_lik, beta, beta_new))
        state, log_inc = reweight(state, beta, beta_new, k_rs)
        log_z += float(log_inc)
        state, acc = mutate(state, beta_new, k_mut, posterior.prior_scales)
        beta = beta_new
        stage += 1
        betas.append(beta)
        ess_hist.append(ess)
        acc_hist.append(float(acc))
        if verbose:
            print(f"[smc] stage={stage} beta={beta:.4f} ess={ess:.0f} "
                  f"accept={float(acc):.3f} logZ={log_z:.2f}")
        if checkpoint_path:
            from mceik_tpu.io.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_path, (state, k_loop), meta={
                "stage": stage, "log_z": log_z, "betas": betas,
                "ess_history": ess_hist, "accept_history": acc_hist})

    return SMCResult(state=state, betas=betas, ess_history=ess_hist,
                     accept_history=acc_hist, log_evidence=log_z,
                     n_stages=stage)


def run_smc_config(config, verbose: bool = True,
                   max_stages: int = 200) -> SMCResult:
    """CLI entry: build the posterior from a RunConfig and run SMC.

    Production sharding path (config 4): when more than one device is
    visible (or DistCfg.n_devices caps it) and the particle count divides,
    the population is sharded over the chains mesh.

    max_stages: ladder cap passed through to run_smc — benchmarks use a
    small cap to measure mutation throughput without walking the full
    ladder to beta=1.
    """
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.dist.mesh import chain_mesh, init_distributed
    from mceik_tpu.model.posterior import build_posterior

    init_distributed(config.dist)
    grid = config.grid.build()
    data, truth = make_dataset(grid, config.data, config.model)
    posterior = build_posterior(config.model, data, grid, config.eikonal)

    scfg = config.sampler
    mesh = chain_mesh(config.dist)
    if mesh.devices.size <= 1 or scfg.n_particles % mesh.devices.size:
        mesh = None
    key = jax.random.PRNGKey(scfg.seed)
    result = run_smc(posterior, key, scfg.n_particles,
                     n_mutation_steps=scfg.n_mutation_steps,
                     ess_threshold=scfg.ess_threshold,
                     step_size=scfg.step_size, verbose=verbose,
                     max_stages=max_stages,
                     mesh=mesh, shard_axis=config.dist.chain_axis,
                     checkpoint_path=config.io.checkpoint_path,
                     resume=config.io.resume)
    if verbose:
        print(f"[smc] done: stages={result.n_stages} "
              f"logZ={result.log_evidence:.2f}"
              + (f" sharded over {mesh.devices.size} devices" if mesh else ""))
    return result
