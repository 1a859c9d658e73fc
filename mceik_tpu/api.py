"""Top-level API (SURVEY.md §1 L7, §3.1): ``run(config) -> RunSummary``.

Wires: config -> grid -> synthetic/loaded data -> posterior -> sampler
dispatch -> jitted scan(vmap(kernel)) -> pooled moments + diagnostics.

Sampling runs in SEGMENTS (length = io.log_every): after each segment a
JSONL metrics record is emitted and, on checkpoint boundaries, the full
sampler state (every chain's params + logpost + adaptation state) is
written atomically — crash recovery resumes exactly (SURVEY.md §5
"Failure detection", "Checkpoint / resume"). Welford moments carry across
segments, so segmentation never changes the statistics.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from mceik_tpu.config import RunConfig
from mceik_tpu.datasets import make_dataset
from mceik_tpu.diag.ess import ess, ess_per_param, split_rhat
from mceik_tpu.diag.moments import welford_finalize, welford_merge_chains
from mceik_tpu.dist.mesh import chain_mesh, init_distributed, shard_chains
from mceik_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from mceik_tpu.io.metrics import MetricsLogger
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.samplers import am, hmc, rwm
from mceik_tpu.samplers.base import MCMCResult, init_chain_states, run_mcmc

# float32 products: a TF32 default on the GPU would keep ~3 digits.
HIGHEST = lax.Precision.HIGHEST


@dataclasses.dataclass
class RunSummary:
    """Host-side results: pooled posterior moments + diagnostics."""

    config: RunConfig
    result: MCMCResult               # device pytrees (states, welford)
    samples: Any                     # concatenated thinned draws (host)
    post_mean: Dict[str, Any]        # pooled posterior means of tracked fields
    post_var: Dict[str, Any]
    accept_rate: float
    rhat_max: float
    ess_logpost: float
    wall_time_s: float
    samples_per_sec: float           # raw chain-steps/s (all chains)
    eff_samples_per_sec: float       # ESS(logpost)/s
    truth: Dict[str, Any]
    recovery_corr: Optional[float]
    # Per-parameter ESS over the tracked field (u, else hypo_raw): the
    # posterior-moments criterion feels min/median over cells, not the
    # scalar logpost ESS (VERDICT r1 weak #6).
    ess_param_min: float = float("nan")
    ess_param_median: float = float("nan")
    # Wall time of each sampling segment (the first one or two include
    # compilation; later ones are steady state).
    segment_seconds: Tuple[float, ...] = ()


def _whitened_setup(posterior, scfg):
    """Laplace setup + whitened u-space view (precondition="whitened").

    Note: unlike the MALA resume path, whitened samplers CANNOT skip the
    Laplace setup on resume — the map x = x_map + L u lives in the kernel
    closure, not the checkpointed state. The setup is deterministic
    (seeded MAP ascent + exact GN covariance), so a resume reconstructs
    the identical map."""
    from mceik_tpu.model.laplace import laplace_preconditioner
    from mceik_tpu.model.whitened import whitened_view
    p_map, cov, _ = laplace_preconditioner(posterior,
                                           n_map_steps=scfg.n_map_steps)
    return whitened_view(posterior, p_map, cov)


def _dispatch_sampler(scfg, posterior, resuming: bool = False):
    """Returns (kernel, adapter, hyper, finalize_fn, state_logpost_fn,
    make_states, params_of) — make_states is None for plain-MHState
    samplers, else a ``(key, n_chains) -> states`` builder (MALA carries
    cached gradients and, when Laplace-preconditioned, initializes chains
    overdispersed around the MAP). ``params_of`` is None when chain-state
    params ARE model params; for whitened-coordinate samplers
    (precondition="whitened") it maps the u-space chain state to model
    params (model/whitened.py).

    ``resuming``: the run will restore (states, hyper) from a checkpoint,
    so expensive setup whose product lives INSIDE those pytrees is
    skipped — specifically the Laplace/GN preconditioner (its pinned
    covariance is in the MALA hyper's count/m2 and its MAP-jittered init
    is irrelevant to restored chains). This is what amortizes the ~60 s
    flagship Laplace setup across segments/resumes (VERDICT r3 #8)."""
    scales = posterior.prior_scales
    example = posterior.init_params(jax.random.PRNGKey(0))
    lp = posterior.logpost
    if scfg.algorithm == "rwm":
        return (rwm.make_kernel(lp), rwm.make_adapter(scfg.target_accept),
                rwm.init_hyper(scales, scfg.step_size), None, lp, None, None)
    if scfg.algorithm == "am":
        return (am.make_kernel(lp), am.make_adapter(scfg.target_accept),
                am.init_hyper(scales, scfg.step_size, example), am.finalize,
                lp, None, None)
    if scfg.algorithm == "am_full":
        # Classic full-covariance Haario AM — for small/medium parameter
        # counts (strongly correlated posteriors where the diagonal
        # variant's mixing collapses); d^2 covariance storage caps it at a
        # few thousand dims.
        from mceik_tpu.samplers import am_full
        return (am_full.make_kernel(lp),
                am_full.make_adapter(scfg.target_accept),
                am_full.init_hyper(scales, scfg.step_size, example),
                am_full.finalize, lp, None, None)
    if scfg.algorithm == "pcn":
        from mceik_tpu.model.params import Params, box_logjac
        from mceik_tpu.samplers import pcn

        if scfg.precondition == "whitened":
            # Generalized pCN w.r.t. the Laplace approximation N(x_map, C):
            # pCN in the whitened coords with unit reference — acceptance
            # driven only by the non-Gaussian residual; gradient-free and
            # dimension-robust (model/whitened.py).
            wv = _whitened_setup(posterior, scfg)
            return (pcn.make_kernel(wv.resid_u),
                    pcn.make_adapter(scfg.target_accept),
                    pcn.init_hyper(wv.scales_u, None, scfg.step_size),
                    pcn.finalize, wv.resid_u,
                    lambda key, n: init_chain_states(wv.resid_u, wv.init_u,
                                                     key, n),
                    wv.params_of)

        def nongauss(p):
            return (box_logjac(p.hypo_raw) if p.hypo_raw is not None
                    else jnp.asarray(0.0, jnp.float32))

        gauss_scales = scales.replace(hypo_raw=None)
        rw_scales = Params(
            u=None, t0=None, log_sigma=None,
            hypo_raw=(None if example.hypo_raw is None
                      else jnp.ones_like(example.hypo_raw)))
        state_lp = lambda p: posterior.log_lik(p) + nongauss(p)
        return (pcn.make_kernel(posterior.log_lik, nongauss),
                pcn.make_adapter(scfg.target_accept),
                pcn.init_hyper(gauss_scales, rw_scales, scfg.step_size),
                pcn.finalize, state_lp, None, None)
    if scfg.algorithm == "hmc":
        target = max(scfg.target_accept, 0.7)
        if scfg.precondition == "whitened":
            wv = _whitened_setup(posterior, scfg)
            return (hmc.make_kernel(wv.logpost_u, scfg.n_leapfrog),
                    hmc.make_adapter(target),
                    hmc.init_hyper(wv.scales_u, scfg.step_size, wv.zero_u),
                    hmc.finalize, wv.logpost_u,
                    lambda key, n: init_chain_states(wv.logpost_u, wv.init_u,
                                                     key, n),
                    wv.params_of)
        return (hmc.make_kernel(lp, scfg.n_leapfrog),
                hmc.make_adapter(target),
                hmc.init_hyper(scales, scfg.step_size, example), hmc.finalize,
                lp, None, None)
    if scfg.algorithm == "nuts":
        from mceik_tpu.samplers import nuts
        target = max(scfg.target_accept, 0.8)
        if scfg.precondition == "whitened":
            # Whitened NUTS == dense-GN-mass NUTS (model/whitened.py):
            # identity diagonal mass in u == mass C^{-1} on x; the dual
            # averaging + diag-mass welford then adapt RESIDUAL structure
            # on top of the GN whitening.
            wv = _whitened_setup(posterior, scfg)
            return (nuts.make_kernel(wv.logpost_u, scfg.max_tree_depth),
                    hmc.make_adapter(target),
                    hmc.init_hyper(wv.scales_u, scfg.step_size, wv.zero_u),
                    hmc.finalize, wv.logpost_u,
                    lambda key, n: init_chain_states(wv.logpost_u, wv.init_u,
                                                     key, n),
                    wv.params_of)
        return (nuts.make_kernel(lp, scfg.max_tree_depth),
                hmc.make_adapter(target),
                hmc.init_hyper(scales, scfg.step_size, example), hmc.finalize,
                lp, None, None)
    if scfg.algorithm == "mala":
        # Preconditioned Metropolis-adjusted Langevin: one gradient/step
        # through the implicit adjoint, full-covariance proposal. With
        # precondition="laplace" the MAP + Gauss-Newton covariance is
        # computed once at startup (model/laplace.py) and pinned — the
        # near-ideal proposal for the near-Gaussian tomography posterior
        # (VERDICT r2 #2); chains initialize overdispersed around the MAP.
        from mceik_tpu.samplers import mala as mala_mod
        target = max(scfg.target_accept, 0.574)
        hyper = mala_mod.init_hyper(scales, scfg.step_size, example)
        adapt_cov = True
        make_states = lambda key, n: mala_mod.init_states(
            lp, posterior.init_params, key, n)
        if scfg.precondition == "laplace" and resuming:
            # Structure-compatible placeholder hyper; the checkpoint's
            # restored hyper carries the real pinned covariance.
            adapt_cov = False
        elif scfg.precondition == "laplace":
            from mceik_tpu.model.laplace import laplace_preconditioner
            p_map, cov, _ = laplace_preconditioner(
                posterior, n_map_steps=scfg.n_map_steps)
            hyper = mala_mod.prime_covariance(hyper, cov)
            adapt_cov = False
            x_map = mala_mod._ravel(p_map)
            active = (mala_mod._ravel(scales) > 0).astype(jnp.float32)
            L_init = jnp.linalg.cholesky(cov).astype(jnp.float32)
            unravel = mala_mod._unravel_fn(p_map)

            def init_one(key):
                # Chains start at the MAP + 0.3x Laplace jitter. Full 1x
                # draws from the Laplace approximation are NOT safe at
                # field scale: the prior-dominated soft subspace (1600+
                # dims at inv 12^3, sd 0.2 in log-slowness) is where the
                # forward model's nonlinearity lives, and a full-sd wiggle
                # of every soft direction lands at logpost ~ -1e6 (vs MAP
                # ~ +1e2, measured on 64^3) — a region no short warmup
                # escapes. 0.3x keeps chains inside the near-Gaussian
                # basin; burn-in is discarded as usual.
                eps = active * jax.random.normal(key, x_map.shape, jnp.float32)
                return unravel(x_map + 0.3 * jnp.matmul(
                    L_init, eps, precision=HIGHEST))

            make_states = lambda key, n: mala_mod.init_states(
                lp, init_one, key, n)
        return (mala_mod.make_kernel(lp),
                mala_mod.make_adapter(target, adapt_cov=adapt_cov),
                hyper, mala_mod.finalize, lp, make_states, None)
    raise ValueError(f"unknown/unsupported algorithm {scfg.algorithm!r} "
                     "(smc has its own entry point: samplers.smc.run_smc)")


def _wrap_noise_gibbs(kernel, gibbs, beta: float = 1.0):
    """Compose a continuous kernel with the exact trans-dimensional noise
    Gibbs sweep (model/posterior.py): continuous move, then indicator scan
    + pseudo-prior refresh, logpost updated from the same residuals.

    ``beta`` tempers only the indicator flip odds (warmup annealing, see
    spike_slab_warmup); the returned logpost is always the un-tempered
    posterior at the new state.
    """
    def kernel2(key, state, hyper):
        k1, k2 = jax.random.split(key)
        state, info = kernel(k1, state, hyper)
        params, lp_prior, lp_lik = gibbs(k2, state.params, beta)
        return state.replace(params=params, logpost=lp_prior + lp_lik), info
    return kernel2


def spike_slab_warmup(base_kernel, gibbs, adapter, states, hyper, key,
                      n_warmup: int, finalize_fn=None,
                      betas=(0.05, 0.2, 0.5, 1.0)):
    """Annealed-Gibbs warmup for spike-slab noise models.

    The indicator flip odds are tempered up a short beta ladder across
    warmup. Rationale (observed failure without it): a cold chain's
    slowness field transiently misfits some clean station; at beta=1 the
    exact Gibbs flags that station, its likelihood weight collapses by the
    slab factor, and the field then has almost no pull left to ever fit it
    — an absorbing metastable mode. Under the ramp, genuinely noisy
    stations (whose log likelihood-ratio is huge) are flagged almost
    immediately while clean stations keep full weight until the field has
    converged; the final rungs run at beta=1, so the post-warmup kernel is
    the exact one and the retained samples are unbiased.

    Returns (states, hyper) ready for sampling at beta=1.
    """
    from mceik_tpu.samplers.base import run_mcmc

    w = max(n_warmup // len(betas), 1)
    parts = [w] * (len(betas) - 1) + [max(n_warmup - w * (len(betas) - 1), 1)]
    for beta, part in zip(betas, parts):
        key, sub = jax.random.split(key)
        kb = _wrap_noise_gibbs(base_kernel, gibbs, beta)
        r = run_mcmc(kb, adapter, states, hyper, sub,
                     n_warmup=part, n_steps=1)
        states, hyper = r.states, r.hyper
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)
    return states, hyper


def _step_size_of(hyper) -> Optional[float]:
    if hasattr(hyper, "log_step"):
        return float(np.exp(np.asarray(hyper.log_step)))
    if hasattr(hyper, "da"):
        return float(np.exp(np.asarray(hyper.da.log_eps)))
    return None


def run(config: RunConfig, verbose: bool = True) -> RunSummary:
    init_distributed(config.dist)
    grid = config.grid.build()
    data, truth = make_dataset(grid, config.data, config.model)

    differentiable = (config.sampler.algorithm in ("hmc", "nuts", "mala")
                      # gpCN is gradient-free per step, but its Laplace
                      # setup (MAP ascent + GN covariance) needs grads.
                      or (config.sampler.algorithm == "pcn"
                          and config.sampler.precondition == "whitened"))
    posterior = build_posterior(config.model, data, grid, config.eikonal,
                                differentiable=differentiable)

    # Resume only if the checkpoint actually exists: a not-yet-written
    # path (e.g. checkpoint_path == resume for restart loops) falls back
    # to a fresh run with full setup instead of skipping the Laplace
    # setup and then failing at load (ADVICE r4).
    resuming = bool(config.io.resume) and os.path.exists(config.io.resume)
    if config.io.resume and not resuming and verbose:
        print(f"[mceik-tpu] resume path {config.io.resume} does not exist "
              "— starting fresh")

    kernel, adapter, hyper, finalize_fn, state_lp, make_states, params_of = \
        _dispatch_sampler(config.sampler, posterior, resuming=resuming)
    base_kernel = kernel
    if posterior.noise_gibbs is not None:
        if params_of is not None:
            raise ValueError(
                "spike_slab noise is not supported with "
                "precondition='whitened': the indicator Gibbs sweep "
                "operates on model params while the chain state lives in "
                "whitened coordinates")
        if config.sampler.algorithm == "pcn":
            raise ValueError(
                "spike_slab noise is not supported with the pcn sampler "
                "(its state tracks log_lik, not the full posterior, and "
                "prior-reversible rotation is undefined for indicators)")
        if config.sampler.algorithm == "mala":
            raise ValueError(
                "spike_slab noise is not supported with the mala sampler: "
                "the indicator Gibbs sweep changes the likelihood weights "
                "behind MALA's cached gradient (MALAState.grad), which "
                "would bias the Langevin drift; use hmc/nuts (recompute "
                "gradients every leapfrog) or am/am_full")
        kernel = _wrap_noise_gibbs(kernel, posterior.noise_gibbs)

    scfg = config.sampler
    key = jax.random.PRNGKey(scfg.seed)
    k_init, k_run = jax.random.split(key)

    if make_states is not None:
        states = make_states(k_init, scfg.n_chains)
    else:
        states = init_chain_states(state_lp, posterior.init_params,
                                   k_init, scfg.n_chains)

    mesh = chain_mesh(config.dist)
    n_dev = mesh.devices.size
    if n_dev > 1 and scfg.n_chains % n_dev == 0:
        states = shard_chains(states, mesh, config.dist.chain_axis)

    n_warmup = scfg.n_warmup
    if resuming:
        (states, hyper), meta = load_checkpoint(config.io.resume, (states, hyper))
        # Provenance check (ADVICE r4): with precondition="laplace" the
        # resume path SKIPS the Laplace setup on the assumption the
        # checkpoint's hyper carries the pinned GN covariance; a
        # structurally-compatible checkpoint from a precondition="none"
        # run would silently freeze a non-GN adapted covariance instead.
        ck_pre = meta.get("precondition")
        if (scfg.algorithm in ("mala", "hmc", "nuts", "pcn")
                and ck_pre is not None and ck_pre != scfg.precondition):
            raise ValueError(
                f"checkpoint {config.io.resume} was written with "
                f"precondition={ck_pre!r} but this run requests "
                f"{scfg.precondition!r} — refusing to resume (the "
                "preconditioner / chain coordinate system would not match "
                "the requested mode)")
        n_warmup = 0  # resumed states are post-warmup
        if verbose:
            print(f"[mceik-tpu] resumed from {config.io.resume} (meta={meta})")

    if posterior.noise_gibbs is not None and n_warmup > 0:
        k_run, k_wu = jax.random.split(k_run)
        states, hyper = spike_slab_warmup(
            base_kernel, posterior.noise_gibbs, adapter, states, hyper,
            k_wu, n_warmup, finalize_fn=finalize_fn)
        n_warmup = 0

    track_slowness = config.model.mode in ("tomo", "joint")

    def track_fn(params):
        # Whitened chains carry u; diagnostics/moments always see model
        # params (the map runs on-device inside the jitted step loop —
        # one (d,d)@(d,) matmul per tracked draw).
        p = params_of(params) if params_of is not None else params
        out = {"params": p}
        if track_slowness:
            out["slowness"] = posterior.slowness_of(p)
        return out

    collect_fn = (params_of if params_of is not None
                  else (lambda params: params))

    # --- segmented sampling loop --------------------------------------
    seg = config.io.log_every if config.io.log_every > 0 else scfg.n_samples
    if config.io.checkpoint_every > 0:
        seg = min(seg, config.io.checkpoint_every)
    seg = max(1, min(seg, scfg.n_samples))
    n_seg = max(1, scfg.n_samples // seg)
    n_steps_actual = n_seg * seg

    logger = MetricsLogger() if verbose else None
    t0 = time.perf_counter()
    seg_results = []
    welford = None
    step_done = 0
    keys = jax.random.split(k_run, n_seg)
    profiled = False
    seg_seconds = []
    for si in range(n_seg):
        t_seg = time.perf_counter()
        # Profile the SECOND segment (first is dominated by compilation).
        if config.io.profile_dir and si == 1 and not profiled:
            jax.profiler.start_trace(config.io.profile_dir)
            profiled = True
        r = run_mcmc(kernel,
                     adapter if si == 0 else None,
                     states, hyper, keys[si],
                     n_warmup=n_warmup if si == 0 else 0,
                     n_steps=seg, thin=scfg.thin,
                     track_fn=track_fn, collect_fn=collect_fn,
                     finalize_fn=finalize_fn if si == 0 else None,
                     init_welford=welford)
        jax.block_until_ready(r.logpost_trace)
        seg_seconds.append(time.perf_counter() - t_seg)
        if profiled and si == 1:
            jax.profiler.stop_trace()
        states, hyper, welford = r.states, r.hyper, r.welford
        step_done += seg
        seg_results.append(r)

        if logger is not None:
            lp = np.asarray(r.logpost_trace)
            logger.log({
                "phase": "sample", "step": step_done,
                "accept": round(float(np.mean(np.asarray(r.accept_trace))), 4),
                "logpost_mean": round(float(lp[-1].mean()), 3),
                "logpost_min": round(float(lp[-1].min()), 3),
                "logpost_max": round(float(lp[-1].max()), 3),
                "step_size": _step_size_of(hyper),
                "chain_steps_per_s": round(
                    step_done * scfg.n_chains / (time.perf_counter() - t0), 2),
            })
        if (config.io.checkpoint_path and config.io.checkpoint_every > 0
                and step_done % config.io.checkpoint_every == 0):
            save_checkpoint(config.io.checkpoint_path, (states, hyper),
                            meta={"step": step_done,
                                  "algorithm": scfg.algorithm,
                                  "precondition": scfg.precondition})
    wall = time.perf_counter() - t0

    if config.io.checkpoint_path:
        save_checkpoint(config.io.checkpoint_path, (states, hyper),
                        meta={"step": step_done, "algorithm": scfg.algorithm,
                              "precondition": scfg.precondition,
                              "final": True})

    # --- host-side summary ---------------------------------------------
    last = seg_results[-1]
    samples = jax.tree.map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *[r.samples for r in seg_results])
    logpost_trace = np.concatenate(
        [np.asarray(r.logpost_trace) for r in seg_results], axis=0)
    accept_trace = np.concatenate(
        [np.asarray(r.accept_trace) for r in seg_results], axis=0)

    pooled = welford_merge_chains(welford)
    mean, var = welford_finalize(pooled)
    post_mean = jax.tree.map(np.asarray, mean)
    post_var = jax.tree.map(np.asarray, var)

    accept = float(np.mean(accept_trace))
    ess_lp = ess(logpost_trace)

    probe = None
    if getattr(samples, "u", None) is not None:
        probe = np.asarray(samples.u).reshape(
            logpost_trace.shape[0], logpost_trace.shape[1], -1)
    elif getattr(samples, "hypo_raw", None) is not None:
        probe = np.asarray(samples.hypo_raw).reshape(
            logpost_trace.shape[0], logpost_trace.shape[1], -1)
    rhat_max = float(np.nanmax(split_rhat(probe))) if probe is not None else float("nan")
    ess_min = ess_med = float("nan")
    if probe is not None:
        pe = ess_per_param(probe)
        ess_min, ess_med = float(np.min(pe)), float(np.median(pe))

    recovery = None
    if track_slowness and "slowness" in truth:
        s_mean = post_mean["slowness"]
        s_true = np.asarray(truth["slowness"])
        a = s_mean - s_mean.mean()
        b = s_true - s_true.mean()
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        recovery = float((a * b).sum() / denom) if denom > 0 else 0.0

    n_total_steps = n_steps_actual * scfg.n_chains
    summary = RunSummary(
        config=config, result=last, samples=samples,
        post_mean=post_mean, post_var=post_var,
        accept_rate=accept, rhat_max=rhat_max, ess_logpost=ess_lp,
        wall_time_s=wall, samples_per_sec=n_total_steps / wall,
        eff_samples_per_sec=ess_lp / wall,
        truth=jax.tree.map(np.asarray, truth), recovery_corr=recovery,
        ess_param_min=ess_min, ess_param_median=ess_med,
        segment_seconds=tuple(seg_seconds),
    )
    if verbose:
        print(f"[mceik-tpu] {scfg.algorithm} chains={scfg.n_chains} "
              f"warmup={n_warmup} samples={n_steps_actual} "
              f"wall={wall:.2f}s accept={accept:.3f} rhat={rhat_max:.3f} "
              f"ess(logpost)={ess_lp:.1f} ess(param min/med)={ess_min:.1f}"
              f"/{ess_med:.1f} samples/s={summary.samples_per_sec:.1f} "
              + (f"recovery_corr={recovery:.3f}" if recovery is not None else ""))
    return summary
