"""Golden-run statistical acceptance harness (SURVEY.md §4 "Statistical
equivalence"; VERDICT r1 next-step #6).

The judge's correctness criterion is posterior moments within Monte-Carlo
error. This module makes that executable: a LONG seeded run of a reduced
config-1/-2-shaped problem produces committed golden moments with MC error
bars (``make_golden`` -> tests/golden/*.json); CI re-runs the same problem
with a DIFFERENT seed at moderate length and asserts per-cell

    z = (mean_test - mean_golden) / sqrt(se_test^2 + se_golden^2) , |z| < 3.5

where each ``se`` is the Monte-Carlo standard error of the posterior-mean
estimate, ``sqrt(var / ESS)`` with autocorrelation-corrected per-cell ESS.
Both runs are fully seeded, so the check is deterministic (calibrated once
at commit time, then a regression tripwire: any drift in the likelihood,
solver, adjoint or sampler kernels moves the test mean off the golden mean
by more than MC error and fails loudly).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np

# Reduced c1-/c2-shaped problems (2-D crosswell RWM-class; 3-D checkerboard
# AM-class). Sizes chosen so the CI-side run stays ~tens of seconds on CPU.
PROBLEMS = {
    "c1_small": {
        "grid": {"shape": [25, 25], "spacing": [1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-4, "max_iters": 50},
        "model": {"mode": "tomo", "inv_shape": [4, 4],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.05},
        "data": {"dataset": "crosswell2d", "n_src": 4, "n_rec": 5,
                 "noise": 0.05, "seed": 77, "checker_cells": [2, 2],
                 "checker_amplitude": 0.08},
    },
    "c2_small": {
        "grid": {"shape": [12, 12, 12], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30},
        # inv 3^3: small enough that full-cov AM reaches per-cell ESS in
        # the hundreds on the golden run (the moment z-test needs mixing,
        # not recovery; a 3^3 basis cannot represent the 2-lobe
        # checkerboard, so truth recovery is asserted separately by
        # tests/test_recovery3d.py at inv 5^3 through the MAP path).
        "model": {"mode": "tomo", "inv_shape": [3, 3, 3],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.05},
        # Volume acquisition (interior shots, multi-face receivers): the
        # face-to-face borehole geometry cannot recover structure stacked
        # along x (all rays near-parallel), so the recovery criterion
        # needs crossing coverage — see datasets/synthetic.py.
        "data": {"dataset": "checkerboard3d_volume", "n_src": 5, "n_rec": 6,
                 "noise": 0.03, "seed": 78, "checker_cells": [2, 2, 2],
                 "checker_amplitude": 0.08},
    },
    # Joint slowness + hypocenters (c3-shaped; VERDICT r2 #7): the
    # north-star names "posterior means and variances of slowness AND
    # event locations", so the moment z-test must cover the event-location
    # path (tables-of-u + hypocenter interpolation + exact weighted t0
    # marginalization). The tracked vector is the FULL active flat params
    # (u cells then hypo_raw), so drift in either block fails CI.
    #
    # Acquisition + kernel (2026-08-21, probed): the r3 definition
    # (surface-only stations, am_full with bootstrapped proposal) does NOT
    # mix — depth-velocity trade-off ridges leave per-cell ESS ~ 5 of 48k
    # draws, the truncation-biased se then makes the z-test fire on pure
    # sampler noise (the r3 red tier). Volume acquisition
    # (events3d_volume: stations on 3 faces) closes the worst ridges, and
    # the Laplace/GN-preconditioned MALA kernel (kernel: "mala") mixes it
    # at eps~0.5, min/med per-cell ESS ~6/60 per 8k draws — so long runs
    # reach valid MC error bars where am_full never equilibrated at all.
    "c3_joint_small": {
        "grid": {"shape": [12, 12, 10], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30},
        "model": {"mode": "joint", "inv_shape": [3, 3, 2],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.04, "marginalize_t0": True},
        "data": {"dataset": "events3d_volume", "n_events": 3,
                 "n_stations": 12, "noise": 0.04, "seed": 79,
                 "checker_cells": [2, 2, 2], "checker_amplitude": 0.08},
        "kernel": "mala",
        # Golden-generation budget override: the slowest ridge direction
        # has tau ~ 1.4k, so 9k steps x 8 chains puts every cell's golden
        # ESS >= ~50 (valid se) at ~40 CPU-minutes — the am_full default
        # budget would cost hours here for no extra benefit.
        "golden_n_steps": 9000, "golden_thin": 3,
    },
    # Intermediate-DIMENSION golden (VERDICT r4 #4): 6^3 = 216-dim
    # inversion basis — an order of magnitude above the 27-dim goldens,
    # an order below the 1728-dim flagship — locating how far z-testable
    # moment verification actually reaches. Probed 2026-08-21 (CPU):
    # GN-preconditioned MALA mixes this posterior near-ideally (whitened
    # eps 0.61, accept 0.61, min cell ESS 320 of 4k draws, tau ~ 12), so
    # the near-Gaussian regime demonstrably extends to 216 dims; the
    # flagship 1728-dim obstruction (BASELINE.md 2026-08-20) lies between.
    "c2_mid": {
        "grid": {"shape": [16, 16, 14], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30},
        "model": {"mode": "tomo", "inv_shape": [6, 6, 6],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.04},
        "data": {"dataset": "checkerboard3d_volume", "n_src": 6, "n_rec": 8,
                 "noise": 0.04, "seed": 80, "checker_cells": [3, 3, 3],
                 "checker_amplitude": 0.08},
        "kernel": "mala",
        "golden_n_steps": 9000, "golden_thin": 3,
    },
}

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "golden")


def _build(name, return_truth: bool = False):
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.posterior import build_posterior

    spec = PROBLEMS[name]
    grid = Grid(shape=tuple(spec["grid"]["shape"]),
                spacing=tuple(spec["grid"]["spacing"]))
    mcfg = ModelCfg(**{k: (tuple(v) if isinstance(v, list) else v)
                       for k, v in spec["model"].items()})
    dcfg = DataCfg(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in spec["data"].items()})
    ecfg = EikonalCfg(**spec["eikonal"])
    data, truth = make_dataset(grid, dcfg, mcfg)
    post = build_posterior(mcfg, data, grid, ecfg,
                           differentiable=(spec.get("kernel") == "mala"))
    if return_truth:
        return post, truth["slowness"]
    return post


def recovery_corr(name: str, mean_u_flat) -> float:
    """Correlation of the posterior-mean slowness field with the truth —
    the checkerboard-recovery integration criterion (SURVEY.md §4
    "Integration"), computed from a check run's mean over u."""
    from mceik_tpu.model.params import slowness_from_u

    post, s_true = _build(name, return_truth=True)
    inv_shape = tuple(PROBLEMS[name]["model"]["inv_shape"])
    u_mean = jnp_asarray(mean_u_flat).reshape(inv_shape)
    s_mean = np.asarray(slowness_from_u(
        u_mean, post.grid, PROBLEMS[name]["model"]["background_slowness"]))
    s_true = np.asarray(s_true)
    a = s_mean - s_mean.mean()
    b = s_true - s_true.mean()
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(x, np.float32))


def run_problem(name: str, seed: int, n_warmup: int, n_steps: int,
                thin: int = 2, proposal: dict = None):
    """Seeded AM run of a golden problem; returns per-cell moment stats.

    ``proposal``: optional ``{"cov": (d,d), "log_step": float}`` from a
    previous (golden) run. When given, the run uses that FIXED
    full-covariance proposal with no adaptation at all — still exact
    Metropolis-Hastings (the proposal is just tuning), but the chain mixes
    from step one, which is what lets the CI-side check reach useful ESS
    in seconds. Without it, the run adapts from scratch (golden
    generation).

    Returns dict with ``mean``, ``var`` (posterior), ``se`` (MC standard
    error of the mean via autocorrelation ESS), ``ess`` — all flattened
    per-cell arrays over the inversion basis u — plus the run's final
    proposal for storage.
    """
    from mceik_tpu.diag.ess import ess_per_param
    from mceik_tpu.samplers import am_full
    from mceik_tpu.samplers.am_full import _ravel
    from mceik_tpu.samplers.base import init_chain_states, run_mcmc

    if PROBLEMS[name].get("kernel") == "mala":
        return _run_problem_mala(name, seed, n_warmup, n_steps, thin,
                                 proposal)

    post = _build(name)
    n_chains = 8
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(seed), n_chains)
    example = post.init_params(jax.random.PRNGKey(seed + 1))
    # Full-covariance Haario AM: these reduced posteriors are strongly
    # correlated across cells and diagonal AM's autocorrelation time
    # exceeds any CI budget (measured tau > 2000 steps on c2_small).
    hyper = am_full.init_hyper(post.prior_scales, 0.3, example)
    kernel = am_full.make_kernel(post.logpost)
    adapter = am_full.make_adapter()
    if proposal is not None:
        cov = np.asarray(proposal["cov"], np.float32)
        n_prime = 1e6  # pin the stored covariance (warmup adaptation can
        # then only retune the global step scale — the Welford update's
        # relative weight is ~steps/n_prime)
        hyper = hyper.replace(
            log_step=np.float32(proposal["log_step"]),
            count=np.float32(n_prime),
            m2=(n_prime - 1.0) * cov)

    # Tracked vector: tomo problems keep the historical u-only layout
    # (committed golden artifacts); joint problems track the FULL active
    # flat params (u cells, then hypo_raw) so the event-location path is
    # under the same z-test.
    collect = (lambda p: p.u) if post.cfg.mode == "tomo" else _ravel
    r = run_mcmc(kernel, adapter, states, hyper,
                 jax.random.PRNGKey(seed + 2), n_warmup=n_warmup,
                 n_steps=n_steps, thin=thin, collect_fn=collect)
    u = np.asarray(r.samples)                   # (n_collect, n_chains, ...)
    n_collect = u.shape[0]
    flat = u.reshape(n_collect, n_chains, -1)
    mean = flat.mean(axis=(0, 1))
    var = flat.var(axis=(0, 1))
    ess = ess_per_param(flat)
    se = np.sqrt(var / np.maximum(ess, 2.0))
    h = r.hyper
    final_proposal = {
        "cov": np.asarray(h.m2 / max(float(h.count) - 1.0, 1.0)),
        "log_step": float(h.log_step),
    }
    # Sample covariance of the draws themselves: the ideal next-round
    # proposal covariance (bootstrap priming for make_golden).
    X = flat.reshape(-1, flat.shape[-1]).astype(np.float64)
    post_cov = np.cov(X.T) + 1e-8 * np.eye(X.shape[1])
    return {"mean": mean, "var": var, "se": se, "ess": ess,
            "accept": float(np.mean(np.asarray(r.accept_trace))),
            "proposal": final_proposal, "post_cov": post_cov}


def _run_problem_mala(name: str, seed: int, n_warmup: int, n_steps: int,
                      thin: int = 2, proposal: dict = None):
    """MALA leg of run_problem for problems with kernel="mala": the
    Laplace/Gauss-Newton covariance (model/laplace.py) is the proposal
    preconditioner — no bootstrap chicken-and-egg — and chains start
    MAP-jittered. Golden generation (proposal=None) computes MAP+cov and
    stores both in the artifact's proposal dict (cov, log_step, x_map);
    check runs reuse them exactly, so the CI leg pays no Laplace setup
    and is deterministic end-to-end."""
    from mceik_tpu.diag.ess import ess_per_param
    from mceik_tpu.samplers import mala
    from mceik_tpu.samplers.base import run_mcmc

    post = _build(name)
    n_chains = 8
    if proposal is None:
        from mceik_tpu.model.laplace import laplace_preconditioner
        p_map, cov, _ = laplace_preconditioner(post, n_map_steps=150)
        cov = np.asarray(cov, np.float64)
        log_step = float(np.log(0.5))
        x_map = np.asarray(mala._ravel(p_map), np.float64)
    else:
        cov = np.asarray(proposal["cov"], np.float64)
        log_step = float(proposal["log_step"])
        x_map = np.asarray(proposal["x_map"], np.float64)

    cov = 0.5 * (cov + cov.T)
    cov += (1e-9 * np.trace(cov) / cov.shape[0]) * np.eye(cov.shape[0])
    L = jnp_asarray(np.linalg.cholesky(cov))
    x_map_j = jnp_asarray(x_map)
    example = post.init_params(jax.random.PRNGKey(seed + 1))
    unravel = mala._unravel_fn(example)

    def init(key):
        import jax.numpy as jnp
        xi = jax.random.normal(key, x_map_j.shape, jnp.float32)
        return unravel(x_map_j + 0.3 * (L @ xi))

    states = mala.init_states(post.logpost, init, jax.random.PRNGKey(seed),
                              n_chains)
    hyper = mala.prime_covariance(
        mala.init_hyper(post.prior_scales, 1.0, example),
        jnp_asarray(cov), log_step=log_step)
    kernel = mala.make_kernel(post.logpost)
    adapter = mala.make_adapter(adapt_cov=False)

    r = run_mcmc(kernel, adapter, states, hyper,
                 jax.random.PRNGKey(seed + 2), n_warmup=n_warmup,
                 n_steps=n_steps, thin=thin, collect_fn=mala._ravel)
    flat = np.asarray(r.samples)
    n_collect = flat.shape[0]
    flat = flat.reshape(n_collect, n_chains, -1)
    mean = flat.mean(axis=(0, 1))
    var = flat.var(axis=(0, 1))
    ess_ = ess_per_param(flat)
    se = np.sqrt(var / np.maximum(ess_, 2.0))
    final_proposal = {
        "cov": cov,
        "log_step": float(np.asarray(r.hyper.log_step)),
        "x_map": x_map,
    }
    X = flat.reshape(-1, flat.shape[-1]).astype(np.float64)
    post_cov = np.cov(X.T) + 1e-8 * np.eye(X.shape[1])
    return {"mean": mean, "var": var, "se": se, "ess": ess_,
            "accept": float(np.mean(np.asarray(r.accept_trace))),
            "proposal": final_proposal, "post_cov": post_cov}


def make_golden(name: str, seed: int = 1000, n_warmup: int = 2000,
                n_steps: int = 24000, thin: int = 4, out_dir: str = None):
    """Generate and write the committed golden artifact for ``name``.

    Bootstrapped proposal tuning: an adaptive round estimates the full
    proposal covariance from scratch; intermediate rounds re-estimate it
    from their own (better-mixed) sample covariance — at ~100+ dims the
    from-scratch Haario estimate is still far from the posterior
    covariance and mixing stays poor without this. The final long round
    uses the settled proposal, which is stored in the artifact so the CI
    check reuses exactly the proposal that produced the golden moments."""
    n_steps = PROBLEMS[name].get("golden_n_steps", n_steps)
    thin = PROBLEMS[name].get("golden_thin", thin)
    if PROBLEMS[name].get("kernel") == "mala":
        # No bootstrap chicken-and-egg: the Laplace/GN covariance is the
        # proposal from step one; a single long run generates the golden.
        stats = run_problem(name, seed + 500, 500, n_steps, thin)
        prop_store = {
            "cov": np.asarray(stats["proposal"]["cov"]).tolist(),
            "log_step": float(stats["proposal"]["log_step"]),
            "x_map": np.asarray(stats["proposal"]["x_map"]).tolist(),
        }
    else:
        warm = run_problem(name, seed, n_warmup, max(n_steps // 8, 500),
                           thin=2)
        prop = {"cov": warm["post_cov"], "log_step": 0.0}
        boot = run_problem(name, seed + 250, 400, max(n_steps // 4, 1000),
                           thin=2, proposal=prop)
        prop = {"cov": boot["post_cov"], "log_step": 0.0}
        stats = run_problem(name, seed + 500, 500, n_steps, thin,
                            proposal=prop)
        prop_store = {
            "cov": np.asarray(prop["cov"]).tolist(),
            "log_step": float(stats["proposal"]["log_step"]),
        }
    artifact = {
        "problem": name,
        "spec": PROBLEMS[name],
        "seed": seed, "n_warmup": n_warmup, "n_steps": n_steps,
        "thin": thin, "n_chains": 8,
        "mean": stats["mean"].tolist(),
        "var": stats["var"].tolist(),
        "se": stats["se"].tolist(),
        "ess": [round(float(e), 1) for e in stats["ess"]],
        "accept": round(stats["accept"], 4),
        "proposal": prop_store,
    }
    out_dir = out_dir or GOLDEN_DIR
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f)
    os.replace(tmp, path)
    return path, artifact


def load_golden(name: str, golden_dir: str = None):
    with open(os.path.join(golden_dir or GOLDEN_DIR, f"{name}.json")) as f:
        return json.load(f)


def z_scores(name: str, golden: dict, seed: int, n_warmup: int,
             n_steps: int, thin: int = 2):
    """CI-side check run (different seed, golden's fixed proposal) ->
    per-cell |z| array."""
    assert golden["spec"] == PROBLEMS[name], (
        "golden artifact spec drifted from PROBLEMS — regenerate goldens "
        "(tools/make_golden.py) if the problem definition changed on purpose")
    stats = run_problem(name, seed, n_warmup, n_steps, thin,
                        proposal=golden["proposal"])
    mean_g = np.asarray(golden["mean"])
    se_g = np.asarray(golden["se"])
    z = (stats["mean"] - mean_g) / np.sqrt(stats["se"] ** 2 + se_g ** 2)
    return np.abs(z), stats
