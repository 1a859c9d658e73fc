"""Gradient-sampler benchmark on the north-star workload: effective
samples/s/chip on 64^3 3-D checkerboard tomography (BASELINE.json metric;
VERDICT r1 next-step #1).

Runs AM (the r1 headline), HMC, and NUTS on the identical config-2-shaped
posterior and reports, per sampler:

  - chain-steps/s (steady state, post-warmup)
  - ESS/s of the scalar logpost (the r1 number — flatters mixing)
  - min / median per-cell ESS/s of the slowness parameters u (the quantity
    the posterior-moments criterion actually feels)

Device work runs in chunks of ~15 s, so that progress is reported as it
goes. Chunk boundaries pass ``t0_offset`` so adaptation schedules stay
continuous.

Usage:
  python tools/gradient_sampler_bench.py [--samplers am,hmc,nuts]
      [--quick] (reduced budgets for smoke-testing the harness)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# Repo root on sys.path, so the script runs from any directory.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

TARGET_CHUNK_S = 15.0


def build(n=64, inv=12, n_src=8, n_rec=12, differentiable=False):
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.posterior import build_posterior

    grid = Grid(shape=(n, n, n), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(inv, inv, inv),
                    prior_sigma_u=0.2, sigma=0.01)
    dcfg = DataCfg(dataset="checkerboard3d", n_src=n_src, n_rec=n_rec,
                   noise=0.01, checker_cells=(3, 3, 3),
                   checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-3, max_iters=20, n_inner=4)
    data, s_true = make_dataset(grid, dcfg, mcfg)
    post = build_posterior(mcfg, data, grid, ecfg,
                           differentiable=differentiable)
    return post, s_true


def run_chunked(kernel, adapter, states, hyper, key, n_warmup, n_steps,
                thin, collect_fn, finalize_fn=None):
    """Warmup + sampling through run_mcmc in ~TARGET_CHUNK_S device
    executions; returns (states, samples, lp_trace, acc_trace, wall_s,
    hyper). wall_s covers the SAMPLING phase only (steady state)."""
    from mceik_tpu.samplers.base import run_mcmc

    # Calibrate per-step cost with a tiny call (also compiles).
    key, sub = jax.random.split(key)
    t0 = time.perf_counter()
    r = run_mcmc(kernel, adapter, states, hyper, sub, n_warmup=1, n_steps=1,
                 t0_offset=0)
    jax.block_until_ready(r.logpost_trace)
    compile_and_two = time.perf_counter() - t0
    states, hyper = r.states, r.hyper
    key, sub = jax.random.split(key)
    t0 = time.perf_counter()
    r = run_mcmc(kernel, adapter, states, hyper, sub, n_warmup=1, n_steps=1,
                 t0_offset=1)
    jax.block_until_ready(r.logpost_trace)
    per_step = max((time.perf_counter() - t0) / 2.0, 1e-3)
    states, hyper = r.states, r.hyper
    chunk = max(1, int(TARGET_CHUNK_S / per_step))

    # UNIFORM chunk sizes (overshooting the requested totals slightly):
    # n_warmup/n_steps are static jit args, so every distinct chunk length
    # compiles a fresh executable (t0_offset is traced and free). One
    # uniform size per phase -> exactly one compile per phase.
    def uniform_chunk(total, c0):
        n_chunks = max(1, -(-total // max(c0, 1)))
        return -(-total // n_chunks), n_chunks

    rem_warm = max(n_warmup - 2, 0)
    if rem_warm:
        wchunk, n_wchunks = uniform_chunk(rem_warm, chunk)
        for i in range(n_wchunks):
            key, sub = jax.random.split(key)
            r = run_mcmc(kernel, adapter, states, hyper, sub,
                         n_warmup=wchunk, n_steps=1,
                         t0_offset=2 + i * wchunk)
            jax.block_until_ready(r.logpost_trace)
            states, hyper = r.states, r.hyper
    if finalize_fn is not None:
        hyper = finalize_fn(hyper)

    schunk, n_schunks = uniform_chunk(
        n_steps, max(chunk - (chunk % thin), thin))
    schunk += (-schunk) % thin
    n_steps = schunk * n_schunks
    samples, lps, accs = [], [], []
    wall = 0.0
    for _ in range(n_schunks):
        key, sub = jax.random.split(key)
        t0 = time.perf_counter()
        r = run_mcmc(kernel, None, states, hyper, sub, n_warmup=0,
                     n_steps=schunk, thin=thin, collect_fn=collect_fn)
        jax.block_until_ready(r.logpost_trace)
        wall += time.perf_counter() - t0
        states = r.states
        samples.append(jax.device_get(r.samples))
        lps.append(np.asarray(r.logpost_trace))
        accs.append(np.asarray(r.accept_trace))
    samples = np.concatenate(samples, axis=0)
    return (states, samples, np.concatenate(lps, 0),
            np.concatenate(accs, 0), wall, hyper, per_step, n_steps)


def summarize(name, wall, n_steps, n_chains, u_draws, lp_trace, extra=None):
    from mceik_tpu.diag.ess import ess, ess_per_param

    lp = np.asarray(lp_trace)
    ess_lp = ess(lp)
    cell = ess_per_param(np.asarray(u_draws))
    steps_s = n_steps * n_chains / wall
    row = {
        "sampler": name,
        "chain_steps_per_s": round(steps_s, 3),
        "ess_logpost_per_s": round(ess_lp / wall, 4),
        "ess_cell_min_per_s": round(float(cell.min()) / wall, 4),
        "ess_cell_med_per_s": round(float(np.median(cell)) / wall, 4),
        "ess_logpost": round(ess_lp, 1),
        "ess_cell_min": round(float(cell.min()), 1),
        "ess_cell_med": round(float(np.median(cell)), 1),
        "wall_s": round(wall, 1),
        "n_chains": n_chains,
        "n_steps": n_steps,
    }
    if extra:
        row.update(extra)
    print(json.dumps(row), flush=True)
    return row


def run_am(post, n_chains=16, n_warmup=300, n_steps=600, thin=2):
    from mceik_tpu.samplers import am
    from mceik_tpu.samplers.base import init_chain_states

    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), n_chains)
    example = post.init_params(jax.random.PRNGKey(1))
    hyper = am.init_hyper(post.prior_scales, 0.05, example)
    kernel = am.make_kernel(post.logpost)
    adapter = am.make_adapter()

    (_, samples, lp, acc, wall, _, _, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda p: p.u)
    return summarize("am", wall, n_steps, n_chains, samples, lp,
                     {"accept": round(float(np.mean(acc)), 3), "thin": thin})


def prime_mass(post_cheap, n_chains=16, n_steps=300):
    """Posterior marginal variances from a short AM run (cheap forward-only
    solves) — a far better mass matrix than anything HMC/NUTS can estimate
    in its own warmup budget, whose barely-moving early chains
    under-estimate the soft directions (measured: cell ESS pinned at the
    estimator floor with self-estimated mass at L=8..15)."""
    from mceik_tpu.samplers import am
    from mceik_tpu.samplers.base import init_chain_states

    states = init_chain_states(post_cheap.logpost, post_cheap.init_params,
                               jax.random.PRNGKey(10), n_chains)
    example = post_cheap.init_params(jax.random.PRNGKey(11))
    hyper = am.init_hyper(post_cheap.prior_scales, 0.05, example)
    kernel = am.make_kernel(post_cheap.logpost)
    adapter = am.make_adapter()
    (_, _, _, _, _, hyper, _, _) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(12),
        n_steps, 2, 2, lambda p: p.u)
    w = hyper.welford
    n = np.maximum(np.asarray(w.count, np.float64), 2.0)
    var = jax.tree.map(lambda m2, s: jnp.maximum(
        jnp.asarray(m2) / (n - 1.0), 1e-8 * s * s).astype(jnp.float32)
        if s is not None else None, w.m2, post_cheap.prior_scales)
    return var, w


def run_grad(post, which="hmc", n_chains=16, n_warmup=80, n_steps=100,
             thin=1, n_leapfrog=8, max_tree_depth=4, step_size0=0.01,
             target_accept=0.8, mass=None):
    from mceik_tpu.samplers import hmc as hmc_mod
    from mceik_tpu.samplers import nuts as nuts_mod
    from mceik_tpu.samplers.base import init_chain_states

    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), n_chains)
    example = post.init_params(jax.random.PRNGKey(1))
    hyper = hmc_mod.init_hyper(post.prior_scales, step_size0, example)
    if mass is not None:
        var, welford = mass
        hyper = hyper.replace(inv_mass=var, welford=welford)
    if which == "hmc":
        kernel = hmc_mod.make_kernel(post.logpost, n_leapfrog=n_leapfrog)
        grads_per_step = n_leapfrog
    else:
        kernel = nuts_mod.make_kernel(post.logpost,
                                      max_tree_depth=max_tree_depth)
        grads_per_step = 2 ** max_tree_depth - 1
    adapter = hmc_mod.make_adapter(target_accept=target_accept)

    (_, samples, lp, acc, wall, hyper, per_step, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda p: p.u,
        finalize_fn=hmc_mod.finalize)

    eps = float(np.exp(np.asarray(hyper.da.log_eps)))
    extra = {"accept": round(float(np.mean(acc)), 3),
             "step_size": round(eps, 5), "grads_per_step": grads_per_step,
             "step_wall_s": round(per_step, 2)}
    if which == "hmc":
        extra["n_leapfrog"] = n_leapfrog
    else:
        extra["max_tree_depth"] = max_tree_depth
    return summarize(which, wall, n_steps, n_chains, samples, lp, extra)


def run_mala(post_g, n_chains=16, n_warmup=40, n_steps=300, thin=1,
             n_map_steps=150, eps0=0.3):
    """Laplace/Gauss-Newton-preconditioned MALA (VERDICT r2 #2): one-time
    MAP + GN-covariance setup (~n_obs adjoint VJPs, model/laplace.py),
    then ONE gradient per step with the exact whitened proposal — the
    full-covariance remedy for per-cell ESS sitting at the estimator
    floor, run at the flagship 64^3/inv-12^3 shape."""
    from mceik_tpu.model.laplace import laplace_preconditioner
    from mceik_tpu.samplers import mala

    t_setup = time.perf_counter()
    p_map, cov, trace = laplace_preconditioner(post_g,
                                               n_map_steps=n_map_steps)
    # float32 inverse is not exactly symmetric; symmetrize + trace-scaled
    # jitter before the host-side factorization used for chain init.
    cov_np = np.asarray(cov, np.float64)
    cov_np = 0.5 * (cov_np + cov_np.T)
    cov_np += (1e-9 * np.trace(cov_np) / cov_np.shape[0]) * np.eye(
        cov_np.shape[0])
    L = jnp.asarray(np.linalg.cholesky(cov_np), jnp.float32)
    setup_wall = time.perf_counter() - t_setup

    x_map = mala._ravel(p_map)
    unravel = mala._unravel_fn(p_map)
    d = x_map.shape[0]

    # Chains start near the MAP with 0.3x Laplace jitter (NOT full 1x
    # draws: at field scale the prior-dominated soft subspace is nonlinear
    # enough that full-sd wiggles land at logpost ~ -1e6 — api.py mala
    # path, measured on 64^3). The bench measures steady-state mixing; MH
    # exactness does not depend on init.
    def init(key):
        xi = jax.random.normal(key, (d,), jnp.float32)
        return unravel(x_map + 0.3 * (L @ xi))

    states = mala.init_states(post_g.logpost, init, jax.random.PRNGKey(0),
                              n_chains)
    hyper = mala.prime_covariance(
        mala.init_hyper(post_g.prior_scales, eps0, p_map), cov)
    kernel = mala.make_kernel(post_g.logpost)
    adapter = mala.make_adapter(adapt_cov=False)

    (_, samples, lp, acc, wall, hyper, per_step, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda p: p.u)
    eps = float(np.exp(np.asarray(hyper.log_step)))
    return summarize("mala", wall, n_steps, n_chains, samples, lp,
                     {"accept": round(float(np.mean(acc)), 3),
                      "step_size": round(eps, 4), "grads_per_step": 1,
                      "laplace_setup_wall_s": round(setup_wall, 1),
                      "map_logpost": round(float(trace[-1]), 1),
                      "step_wall_s": round(per_step, 3)})


def run_am_full(post, post_g, n_chains=16, n_warmup=60, n_steps=600,
                thin=2, n_map_steps=150):
    """Full-covariance Haario AM at the flagship 1728-dim shape (VERDICT
    r2 #2's other half): the proposal covariance is PRIMED with the
    Laplace/GN covariance (learning it from history needs > 2d pooled
    samples — hours at this shape), so this measures the gradient-FREE
    full-covariance kernel: 1 forward likelihood/step, 0.234-target RWM
    scaling."""
    from mceik_tpu.model.laplace import laplace_preconditioner
    from mceik_tpu.samplers import am_full, mala
    from mceik_tpu.samplers.base import MHState

    t_setup = time.perf_counter()
    p_map, cov, _ = laplace_preconditioner(post_g, n_map_steps=n_map_steps)
    cov_np = np.asarray(cov, np.float64)
    cov_np = 0.5 * (cov_np + cov_np.T)
    cov_np += (1e-9 * np.trace(cov_np) / cov_np.shape[0]) * np.eye(
        cov_np.shape[0])
    L = jnp.asarray(np.linalg.cholesky(cov_np), jnp.float32)
    setup_wall = time.perf_counter() - t_setup

    x_map = mala._ravel(p_map)
    unravel = mala._unravel_fn(p_map)

    def init(key):
        # 0.3x Laplace jitter (see run_mala's note on full 1x draws).
        xi = jax.random.normal(key, x_map.shape, x_map.dtype)
        return unravel(x_map + 0.3 * (L @ xi))

    keys = jax.random.split(jax.random.PRNGKey(0), n_chains)
    params = jax.vmap(init)(keys)
    logpost = jax.vmap(post.logpost)(params)
    states = MHState(params=params, logpost=logpost)
    hyper = mala.prime_covariance(
        am_full.init_hyper(post.prior_scales, 1.0, p_map), cov)
    kernel = am_full.make_kernel(post.logpost)
    # Step-size-only adaptation (covariance pinned, same rationale as
    # mala.make_adapter(adapt_cov=False)): reuse MALA's adapter with the
    # RWM-optimal target — hyper layout (AMFullHyper) is shared.
    adapter = mala.make_adapter(target_accept=0.234, adapt_cov=False)

    (_, samples, lp, acc, wall, hyper, per_step, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda p: p.u)
    return summarize("am_full", wall, n_steps, n_chains, samples, lp,
                     {"accept": round(float(np.mean(acc)), 3),
                      "laplace_setup_wall_s": round(setup_wall, 1),
                      "step_wall_s": round(per_step, 3), "thin": thin})


def _laplace_whitened(post_g, n_map_steps=150):
    """Shared Laplace setup for the whitened-coordinate samplers
    (model/whitened.py — VERDICT r4 #2)."""
    from mceik_tpu.model.laplace import laplace_preconditioner
    from mceik_tpu.model.whitened import whitened_view

    t0 = time.perf_counter()
    p_map, cov, trace = laplace_preconditioner(post_g,
                                               n_map_steps=n_map_steps)
    wv = whitened_view(post_g, p_map, cov)
    return wv, time.perf_counter() - t0, float(trace[-1])


def run_nuts_whitened(post_g, wv, setup_wall, n_chains=16, n_warmup=24,
                      n_steps=40, thin=1, max_tree_depth=4,
                      step_size0=0.05):
    """Whitened NUTS == dense-GN-mass NUTS (the r4 #2 lever (a)): unit
    diagonal mass in u-space; trajectories can track the position-
    dependent soft-subspace curvature that defeated the one-step pinned
    MALA proposal."""
    from mceik_tpu.samplers import hmc as hmc_mod
    from mceik_tpu.samplers import nuts as nuts_mod
    from mceik_tpu.samplers.base import init_chain_states

    states = init_chain_states(wv.logpost_u, wv.init_u,
                               jax.random.PRNGKey(0), n_chains)
    hyper = hmc_mod.init_hyper(wv.scales_u, step_size0, wv.zero_u)
    kernel = nuts_mod.make_kernel(wv.logpost_u,
                                  max_tree_depth=max_tree_depth)
    adapter = hmc_mod.make_adapter(target_accept=0.8)

    (_, samples, lp, acc, wall, hyper, per_step, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda u: wv.params_of(u).u,
        finalize_fn=hmc_mod.finalize)
    eps = float(np.exp(np.asarray(hyper.da.log_eps)))
    return summarize("nuts_w", wall, n_steps, n_chains, samples, lp,
                     {"accept": round(float(np.mean(acc)), 3),
                      "step_size": round(eps, 5),
                      "grads_per_step": 2 ** max_tree_depth - 1,
                      "max_tree_depth": max_tree_depth,
                      "laplace_setup_wall_s": round(setup_wall, 1),
                      "step_wall_s": round(per_step, 2)})


def run_gpcn(post_g, wv, setup_wall, n_chains=16, n_warmup=300,
             n_steps=3000, thin=5, rho0=0.1):
    """Generalized pCN w.r.t. the Laplace approximation (the r4 #2 lever
    (b), gradient-FREE): pCN in whitened coords with unit reference —
    acceptance driven only by the non-Gaussian residual, one forward
    likelihood per step (AM-class cost)."""
    from mceik_tpu.samplers import pcn as pcn_mod
    from mceik_tpu.samplers.base import init_chain_states

    states = init_chain_states(wv.resid_u, wv.init_u,
                               jax.random.PRNGKey(0), n_chains)
    hyper = pcn_mod.init_hyper(wv.scales_u, None, rho0)
    kernel = pcn_mod.make_kernel(wv.resid_u)
    adapter = pcn_mod.make_adapter(target_accept=0.234)

    (_, samples, lp, acc, wall, hyper, per_step, n_steps) = run_chunked(
        kernel, adapter, states, hyper, jax.random.PRNGKey(2),
        n_warmup, n_steps, thin, lambda u: wv.params_of(u).u,
        finalize_fn=pcn_mod.finalize)
    rho = float(jax.nn.sigmoid(hyper.log_rho))
    return summarize("gpcn", wall, n_steps, n_chains, samples, lp,
                     {"accept": round(float(np.mean(acc)), 3),
                      "rho": round(rho, 4), "thin": thin,
                      "laplace_setup_wall_s": round(setup_wall, 1),
                      "step_wall_s": round(per_step, 3)})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--samplers", default="am,hmc,nuts")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n-chains", type=int, default=16)
    ap.add_argument("--n-leapfrog", type=int, default=8)
    ap.add_argument("--max-tree-depth", type=int, default=4)
    # MALA warmup/window overrides: the 2026-08-20 run showed the default
    # 40-step warmup freezes the RM step size mid-collapse (init-transient
    # rejections drive eps 0.3 -> 0.029 before recovery; sampling then
    # runs with no adapter), pinning tau in the thousands. A long warmup
    # lets eps reach its 0.574-acceptance equilibrium before the timed
    # window.
    ap.add_argument("--mala-warmup", type=int, default=None)
    ap.add_argument("--mala-steps", type=int, default=None)
    # Same RM-freeze question for am_full (its 2026-08-20 run ended at
    # accept 0.144 vs the 0.234 target after a 60-step warmup).
    ap.add_argument("--amfull-warmup", type=int, default=None)
    ap.add_argument("--amfull-steps", type=int, default=None)
    # Plain-NUTS long-window overrides (VERDICT r4 #3).
    ap.add_argument("--nuts-warmup", type=int, default=None)
    ap.add_argument("--nuts-steps", type=int, default=None)
    # Whitened-coordinate samplers (VERDICT r4 #2).
    ap.add_argument("--nutsw-warmup", type=int, default=None)
    ap.add_argument("--nutsw-steps", type=int, default=None)
    ap.add_argument("--nutsw-depth", type=int, default=4)
    ap.add_argument("--gpcn-warmup", type=int, default=None)
    ap.add_argument("--gpcn-steps", type=int, default=None)
    args = ap.parse_args()
    q = args.quick

    print(json.dumps({"device": {"platform": jax.devices()[0].platform,
                                 "kind": jax.devices()[0].device_kind,
                                 "count": len(jax.devices())},
                      "workload": "checkerboard3d 64^3, 8 src, 12 rec, "
                                  "inv 12^3, tol 1e-3"}), flush=True)
    names = args.samplers.split(",")
    if "am" in names:
        post, _ = build(differentiable=False)
        run_am(post, n_chains=args.n_chains,
               n_warmup=(50 if q else 300), n_steps=(60 if q else 600),
               thin=2)
    if "mala" in names:
        post_g, _ = build(differentiable=True)
        run_mala(post_g, n_chains=args.n_chains,
                 n_warmup=(args.mala_warmup or (10 if q else 40)),
                 n_steps=(args.mala_steps or (20 if q else 300)),
                 n_map_steps=(40 if q else 150))
    if "am_full" in names:
        post, _ = build(differentiable=False)
        post_g, _ = build(differentiable=True)
        run_am_full(post, post_g, n_chains=args.n_chains,
                    n_warmup=(args.amfull_warmup or (10 if q else 60)),
                    n_steps=(args.amfull_steps or (30 if q else 600)),
                    n_map_steps=(40 if q else 150))
    if "hmc" in names or "nuts" in names:
        post_cheap, _ = build(differentiable=False)
        mass = prime_mass(post_cheap, n_chains=args.n_chains,
                          n_steps=(40 if q else 300))
        post_g, _ = build(differentiable=True)
        if "hmc" in names:
            run_grad(post_g, "hmc", n_chains=args.n_chains,
                     n_warmup=(8 if q else 30),
                     n_steps=(10 if q else 80),
                     n_leapfrog=args.n_leapfrog, mass=mass)
        if "nuts" in names:
            run_grad(post_g, "nuts", n_chains=args.n_chains,
                     n_warmup=(args.nuts_warmup or (6 if q else 24)),
                     n_steps=(args.nuts_steps or (8 if q else 40)),
                     max_tree_depth=args.max_tree_depth, mass=mass)
    if "nuts_w" in names or "gpcn" in names:
        post_g, _ = build(differentiable=True)
        wv, setup_wall, map_lp = _laplace_whitened(
            post_g, n_map_steps=(40 if q else 150))
        print(json.dumps({"laplace_setup_wall_s": round(setup_wall, 1),
                          "map_logpost": round(map_lp, 1)}), flush=True)
        if "nuts_w" in names:
            run_nuts_whitened(
                post_g, wv, setup_wall, n_chains=args.n_chains,
                n_warmup=(args.nutsw_warmup or (6 if q else 24)),
                n_steps=(args.nutsw_steps or (8 if q else 40)),
                max_tree_depth=args.nutsw_depth)
        if "gpcn" in names:
            run_gpcn(post_g, wv, setup_wall, n_chains=args.n_chains,
                     n_warmup=(args.gpcn_warmup or (30 if q else 300)),
                     n_steps=(args.gpcn_steps or (60 if q else 3000)))


if __name__ == "__main__":
    main()
