"""Benchmark: effective samples/s/chip on 3-D checkerboard tomography
(BASELINE.json's north-star metric; SURVEY.md §6; VERDICT r1 #1, r2 #1/#2).

Runs the config-2-shaped workload (64^3 checkerboard, inv 12^3, 8 src,
12 rec) with THREE kernels — adaptive Metropolis, Laplace-preconditioned
MALA (model/laplace.py + samplers/mala.py), and NUTS — and prints ONE
JSON line:

    {"metric": ..., "value": N, "unit": ..., "device": {...}, "extra": {...}}

HEADLINE POLICY (single definition — code below follows it exactly;
VERDICT r3 weak #1): the headline is the best ESS(logpost)/s across the
measured kernels whose measurement window makes the ESS estimate
trustworthy, defined as BOTH (a) >= 20 post-warmup draws per chain and
(b) estimated ESS <= 0.8 x the total draw count (an estimate pinned at
the window size is censored, not measured). Ineligible kernels are still
reported in "extra" with an ``_eligible`` flag. Each kernel's ESS is
computed over a fixed window length (AM: 150 draws/chain) — Geyer ESS is truncation-limited, so window length is part
of the metric's definition and mixing window sizes would fabricate
movement (extras carry am_eff_long for the 300-draw value). Per-cell
slowness ESS/s —
the statistic the posterior-moments criterion actually feels — also rides
in "extra" for every kernel, but per-cell ESS in these short windows sits
at the Geyer estimator floor (~n_chains/2 per cell) for every kernel at
inv=12^3; the long-window per-cell measurements live in BASELINE.md
(tools/gradient_sampler_bench.py), not here. There are no published
reference numbers (reference mount empty, see BASELINE.md).

Device work runs in short chunks (``sample_chunked``); longer-window
measurements live in tools/gradient_sampler_bench.py. The benchmark needs
a GPU: it exits with an error when JAX finds none, and every result names
the device's platform, kind and count. ROADMAP S1 replaces this script
with one cell per deployment.
"""

import json
import time

import jax
import numpy as np


def sample_chunked(run_mcmc, kernel, states, hyper, key, n_steps, chunk,
                   collect_fn):
    """Post-warmup sampling in <=chunk-step executions; returns
    (states, samples, lp_trace, acc_trace, wall_s, welford).

    The FIRST chunk is excluded from BOTH the wall clock and the traces
    (it compiles the sampling graph, which must not contaminate the
    throughput number, and serves as extra burn-in), so
    ESS/s uses the timed chunks' wall with the timed chunks' draws. The
    Welford accumulator is threaded ACROSS the timed chunks so the
    returned moments cover the whole measured window, not just the last
    chunk (ADVICE r3); it is RE-INITIALIZED after the burn-in chunk so
    moments and traces cover the SAME window (ADVICE r4 — the fresh
    accumulator has an identical pytree structure, so run_mcmc still
    compiles exactly once)."""
    from mceik_tpu.diag.moments import welford_init

    samples, lps, accs = [], [], []
    wall = 0.0
    n_chains = states.logpost.shape[0]
    fresh_welford = lambda: welford_init(
        jax.tree.map(lambda x: x[0], states.params), batch_shape=(n_chains,))
    welford = fresh_welford()
    for i in range(1 + -(-n_steps // chunk)):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        r = run_mcmc(kernel, None, states, hyper, sub, n_warmup=0,
                     n_steps=chunk, collect_fn=collect_fn,
                     init_welford=welford)
        jax.block_until_ready(r.logpost_trace)
        if i > 0:
            wall += time.perf_counter() - t0
            samples.append(np.asarray(jax.device_get(r.samples)))
            lps.append(np.asarray(r.logpost_trace))
            accs.append(np.asarray(r.accept_trace))
        states = r.states
        # Drop the burn-in chunk's contribution: moments == traces window.
        welford = fresh_welford() if i == 0 else r.welford
    return (states, np.concatenate(samples, 0), np.concatenate(lps, 0),
            np.concatenate(accs, 0), wall, welford)


def main():
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.diag.ess import ess, ess_per_param
    from mceik_tpu.diag.moments import welford_merge_chains
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.laplace import laplace_preconditioner
    from mceik_tpu.model.posterior import build_posterior
    from mceik_tpu.samplers import am, hmc, mala, nuts
    from mceik_tpu.samplers.base import init_chain_states, run_mcmc

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev}")

    n = 64
    grid = Grid(shape=(n, n, n), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(12, 12, 12), prior_sigma_u=0.2,
                    sigma=0.01)
    dcfg = DataCfg(dataset="checkerboard3d", n_src=8, n_rec=12, noise=0.01,
                   checker_cells=(3, 3, 3), checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-3, max_iters=20, n_inner=4)

    data, _ = make_dataset(grid, dcfg, mcfg)
    posterior = build_posterior(mcfg, data, grid, ecfg)

    # 16 chains x 8 sources = 128 fields per batched solve (ROADMAP S5
    # finds the knee of chains per card).
    n_chains = 16
    states = init_chain_states(posterior.logpost, posterior.init_params,
                               jax.random.PRNGKey(0), n_chains)
    example = posterior.init_params(jax.random.PRNGKey(1))
    hyper = am.init_hyper(posterior.prior_scales, 0.05, example)
    kernel = am.make_kernel(posterior.logpost)
    # target_accept=0.4, NOT the 0.234 library default: on this workload
    # the headline statistic is ESS(logpost)/s and the measured optimum
    # sits at accept ~0.4 (the r1-r4 benches ran there — the old RM tuner
    # never traveled from the 0.05 init step in 50 warmup steps, which
    # accidentally pinned the good operating point; the r5 dual-averaging
    # tuner actually REACHES its target, so the bench now states the
    # workload-tuned target explicitly: with target 0.234 the bigger
    # steps cost ~35% of ESS_lp/s while per-cell ESS stays at the
    # estimator floor either way — 2026-08-21, /tmp bench_r5_4/5 runs).
    adapter = am.make_adapter(target_accept=0.4)

    # --- AM: warm up adaptation + compile, then timed steady state -------
    r0 = run_mcmc(kernel, adapter, states, hyper, jax.random.PRNGKey(2),
                  n_warmup=50, n_steps=1)
    jax.block_until_ready(r0.logpost_trace)
    r0 = r0.replace(hyper=am.finalize(r0.hyper))

    # 300 timed draws/chain, but the HEADLINE uses the first 150 (and
    # their wall) — like-for-like with the locked 1.70 baseline, which was
    # measured with the same 150-draw procedure. Geyer ESS at these
    # windows is truncation-limited: the 300-draw estimate sees more of
    # the autocorrelation tail and reads systematically lower ESS/s
    # (measured 2026-08-21: tau_lp ~68 at 150 draws vs ~107 at 300), so
    # comparing a long-window number against the short-window baseline
    # would fabricate a regression. The honest long-window value rides in
    # extras as am_eff_long.
    (_, asamples, lp, _, wall_am, am_welford) = sample_chunked(
        run_mcmc, kernel, r0.states, r0.hyper, jax.random.PRNGKey(3),
        n_steps=300, chunk=50, collect_fn=lambda p: p.u)
    steps_s_am = lp.shape[0] * n_chains / wall_am
    lp150 = lp[:150]
    wall_am150 = wall_am * (150 / lp.shape[0])
    ess_lp_am = ess(lp150)
    cell_am = ess_per_param(asamples)
    eff_am = ess_lp_am / wall_am150
    eff_am_long = ess(lp) / wall_am

    # --- MALA: Laplace/Gauss-Newton preconditioner, 1 gradient/step ------
    # (VERDICT r2 #2: the full-covariance remedy for per-cell ESS at the
    # estimator floor; setup = MAP + GN covariance, ~n_obs adjoint VJPs.)
    post_g = build_posterior(mcfg, data, grid, ecfg, differentiable=True)
    t0 = time.perf_counter()
    p_map, cov, _ = laplace_preconditioner(post_g, n_map_steps=60,
                                           n_newton=8)
    cov_np = np.asarray(cov, np.float64)
    cov_np = 0.5 * (cov_np + cov_np.T)
    cov_np += (1e-9 * np.trace(cov_np) / cov_np.shape[0]) * np.eye(
        cov_np.shape[0])
    Lc = jax.numpy.asarray(np.linalg.cholesky(cov_np), jax.numpy.float32)
    setup_wall = time.perf_counter() - t0

    x_map = mala._ravel(p_map)
    unravel = mala._unravel_fn(p_map)

    def init_laplace(key):
        # 0.3x Laplace jitter, NOT full 1x draws: at field scale the
        # prior-dominated soft subspace is nonlinear enough that full-sd
        # wiggles land at logpost ~ -1e6 (api.py's mala path, measured).
        xi = jax.random.normal(key, x_map.shape, x_map.dtype)
        return unravel(x_map + 0.3 * jax.numpy.matmul(
            Lc, xi, precision=jax.lax.Precision.HIGHEST))

    mstates = mala.init_states(post_g.logpost, init_laplace,
                               jax.random.PRNGKey(7), n_chains)
    mhyper = mala.prime_covariance(
        mala.init_hyper(post_g.prior_scales, 0.3, p_map), cov)
    mkernel = mala.make_kernel(post_g.logpost)
    madapter = mala.make_adapter(adapt_cov=False)
    for i in range(2):                       # 2 x 5-step warmup chunks
        m0 = run_mcmc(mkernel, madapter, mstates, mhyper,
                      jax.random.PRNGKey(8 + i), n_warmup=5, n_steps=1,
                      t0_offset=5 * i)
        jax.block_until_ready(m0.logpost_trace)
        mstates, mhyper = m0.states, m0.hyper
    mhyper = mala.finalize(mhyper)
    (_, msamples, mlp, macc, wall_m, _) = sample_chunked(
        run_mcmc, mkernel, mstates, mhyper, jax.random.PRNGKey(10),
        n_steps=40, chunk=10, collect_fn=lambda p: p.u)
    eff_mala = ess(mlp) / wall_m
    cell_mala = ess_per_param(msamples)
    steps_s_mala = mlp.shape[0] * n_chains / wall_m

    # --- NUTS: AM-primed diag mass, short steady-state window ------------
    # (gradient path: implicit-adjoint swept transport; BASELINE.md r2.)
    # run_mcmc's welford is PER-CHAIN (count (C,), m2 leaves (C, ...)); the
    # NUTS mass priming needs the POOLED accumulator (scalar count) — both
    # for the variance broadcast here and because hmc's warmup adapter
    # merges chain batches into it (VERDICT r2 missing #1).
    w = welford_merge_chains(am_welford)
    cnt = np.maximum(float(w.count), 2.0)
    var = jax.tree.map(
        lambda m2, s: (jax.numpy.maximum(
            jax.numpy.asarray(m2) / (cnt - 1.0), 1e-8 * s * s)
            .astype(jax.numpy.float32)) if s is not None else None,
        w.m2, posterior.prior_scales)
    gstates = init_chain_states(post_g.logpost, post_g.init_params,
                                jax.random.PRNGKey(4), n_chains)
    ghyper = hmc.init_hyper(post_g.prior_scales, 0.005, example)
    # Prime BOTH the mass and the welford: the warmup adapter recomputes
    # inv_mass from its welford each step, so a primed welford (count >
    # mass_start) is what makes the AM-estimated variances stick.
    ghyper = ghyper.replace(inv_mass=var, welford=w)
    gkernel = nuts.make_kernel(post_g.logpost, max_tree_depth=4)
    # Adapter constructed ONCE: run_mcmc jits with adapt_fn STATIC, so a
    # fresh make_adapter() closure per chunk would recompile the whole
    # warmup program every chunk.
    gadapter = hmc.make_adapter(0.8)
    for i in range(3):                       # 3 x 2-step warmup chunks
        g0 = run_mcmc(gkernel, gadapter, gstates, ghyper,
                      jax.random.PRNGKey(5 + i), n_warmup=2, n_steps=1,
                      t0_offset=2 * i)
        jax.block_until_ready(g0.logpost_trace)
        gstates, ghyper = g0.states, g0.hyper
    ghyper = hmc.finalize(ghyper)

    # 21 draws/chain (7 x 3-step chunks) — the minimum window that makes
    # NUTS headline-eligible under
    # the policy above; r3's 6-draw window produced an ESS estimate at
    # ~0.8x the window and was (rightly, but silently) excluded.
    (_, gsamples, glp, gacc, wall_g, _) = sample_chunked(
        run_mcmc, gkernel, gstates, ghyper, jax.random.PRNGKey(6),
        n_steps=21, chunk=3, collect_fn=lambda p: p.u)
    eff_nuts = ess(glp) / wall_g
    cell_nuts = ess_per_param(gsamples)
    steps_s_nuts = glp.shape[0] * n_chains / wall_g

    # --- SMC leg (config-4 workload, 4096 particles, 12 stages):
    # mutation throughput.
    from mceik_tpu.io.config_io import apply_overrides, load_config
    from mceik_tpu.samplers.smc import run_smc_config

    c4 = apply_overrides(load_config("configs/c4_smc.json"),
                         ["sampler.n_particles=4096"])
    t0 = time.perf_counter()
    sr = run_smc_config(c4, verbose=False, max_stages=12)
    wall_smc = time.perf_counter() - t0
    n_mut = 4096 * c4.sampler.n_mutation_steps * sr.n_stages
    smc_extra = {
        "smc_particle_mutation_steps_per_s": round(n_mut / wall_smc, 0),
        "smc_n_stages": sr.n_stages,
        "smc_beta_reached": round(float(sr.betas[-1]), 4),
        "smc_mean_accept": round(sum(sr.accept_history)
                                 / max(len(sr.accept_history), 1), 3),
        "wall_s_smc": round(wall_smc, 3),
    }

    # --- headline: the policy stated in the module docstring -------------
    def eligible(lp_trace):
        n_draw_chain, n_tot = lp_trace.shape[0], lp_trace.size
        return n_draw_chain >= 20 and ess(lp_trace) <= 0.8 * n_tot

    candidates = {"am": (eff_am, eligible(lp150)),
                  "mala": (eff_mala, eligible(mlp)),
                  "nuts": (eff_nuts, eligible(glp))}
    value = max([v for v, ok in candidates.values() if ok] or [eff_am])
    print(json.dumps({
        "metric": "eff_samples_per_s_chip_3d_checkerboard64",
        "value": round(value, 4),
        "unit": "ESS(logpost)/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": {
            "am_eff_samples_per_s": round(eff_am, 4),
            "am_eff_long": round(eff_am_long, 4),
            "am_chain_steps_per_s": round(steps_s_am, 3),
            "am_ess_cell_min_per_s": round(float(cell_am.min()) / wall_am, 4),
            "am_ess_cell_med_per_s": round(float(np.median(cell_am)) / wall_am, 4),
            "mala_eff_samples_per_s": round(eff_mala, 4),
            "mala_chain_steps_per_s": round(steps_s_mala, 3),
            "mala_ess_cell_min_per_s": round(float(cell_mala.min()) / wall_m, 4),
            "mala_ess_cell_med_per_s": round(float(np.median(cell_mala)) / wall_m, 4),
            "mala_accept": round(float(macc.mean()), 3),
            "mala_laplace_setup_wall_s": round(setup_wall, 1),
            # Honesty at short run lengths (VERDICT r3 #8): ESS/s with the
            # one-time Laplace setup amortized INTO this window's wall.
            "mala_eff_incl_setup": round(
                ess(mlp) / (wall_m + setup_wall), 4),
            "nuts_eff_samples_per_s": round(eff_nuts, 4),
            "nuts_chain_steps_per_s": round(steps_s_nuts, 3),
            "nuts_ess_cell_min_per_s": round(float(cell_nuts.min()) / wall_g, 4),
            "nuts_ess_cell_med_per_s": round(float(np.median(cell_nuts)) / wall_g, 4),
            "am_eligible": candidates["am"][1],
            "mala_eligible": candidates["mala"][1],
            "nuts_eligible": candidates["nuts"][1],
            # Window sizes per kernel (VERDICT r4 weak #6): Geyer ESS
            # error bars scale ~1/sqrt(window); NUTS's 21-draw window is
            # the eligibility minimum, so its eff estimate carries much
            # wider error bars than AM's 150-draw one. Long-window
            # measurements live in BASELINE.md.
            "window_draws_per_chain": {
                "am": int(lp150.shape[0]), "mala": int(mlp.shape[0]),
                "nuts": int(glp.shape[0])},
            "wall_s_am": round(wall_am, 3),
            "wall_s_mala": round(wall_m, 3),
            "wall_s_nuts": round(wall_g, 3),
            "n_chains": n_chains,
            **smc_extra,
        },
    }))


if __name__ == "__main__":
    main()
