"""Model-mode coverage (SURVEY.md §2.1 rows "Hypocenter grid-search /
locate mode", "Priors" hierarchy): locate, joint, hierarchical noise,
origin-time marginalization — all on tiny grids."""

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.model.params import box_from_raw
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.samplers import hmc, rwm
from mceik_tpu.samplers.base import init_chain_states, run_mcmc

GRID = Grid(shape=(17, 17, 13), spacing=(1.0, 1.0, 1.0))
ECFG = EikonalCfg(method="sweep", tol=1e-4, max_iters=50)


def _events_setup(mode, **model_kw):
    mcfg = ModelCfg(mode=mode, inv_shape=(4, 4, 3), prior_sigma_u=0.15,
                    sigma=0.01, **model_kw)
    dcfg = DataCfg(dataset="events3d", n_events=3, n_stations=8, noise=0.005,
                   seed=7, checker_cells=(2, 2, 2), checker_amplitude=0.0)
    data, truth = make_dataset(GRID, dcfg, mcfg, _eik())
    post = build_posterior(mcfg, data, GRID, ECFG,
                           differentiable=(mode == "joint"))
    return post, data, truth


def _eik():
    from mceik_tpu.eikonal.solve import EikonalConfig
    return EikonalConfig(method="sweep", tol=1e-4, max_iters=50)


def test_locate_mode_recovers_hypocenters():
    """Locate mode (fixed homogeneous slowness, amplitude=0 truth): HMC on
    hypocenters + origin times should land on the true locations."""
    post, data, truth = _events_setup("locate")
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), 4)
    ex = post.init_params(jax.random.PRNGKey(1))
    result = run_mcmc(
        hmc.make_kernel(post.logpost, n_leapfrog=10), hmc.make_adapter(),
        states, hmc.init_hyper(post.prior_scales, 0.05, ex),
        jax.random.PRNGKey(2), n_warmup=400, n_steps=600,
        finalize_fn=hmc.finalize)
    # Posterior-mean hypocenters within ~1.5 grid cells of truth.
    raw_mean = np.asarray(
        jax.tree.map(lambda x: x, result.welford.mean).hypo_raw).mean(axis=0)
    hypo_mean = np.asarray(box_from_raw(jnp.asarray(raw_mean), GRID))
    err = np.linalg.norm(hypo_mean - np.asarray(truth["hypo"]), axis=-1)
    assert err.max() < 2.0, (hypo_mean, np.asarray(truth["hypo"]))
    # Origin times recovered too.
    t0_mean = np.asarray(result.welford.mean.t0).mean(axis=0)
    assert np.abs(t0_mean - np.asarray(truth["t0"])).max() < 0.25


def test_joint_mode_logpost_and_grads():
    post, _, _ = _events_setup("joint")
    p = post.init_params(jax.random.PRNGKey(0))
    lp, g = jax.value_and_grad(post.logpost)(p)
    assert np.isfinite(float(lp))
    for leaf in jax.tree.leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()


def test_hierarchical_noise_and_marginalized_t0():
    post, _, _ = _events_setup("locate", hierarchical_noise=True,
                               per_station_noise=True, marginalize_t0=True)
    p = post.init_params(jax.random.PRNGKey(0))
    assert p.t0 is None  # marginalized out
    assert p.log_sigma is not None and p.log_sigma.shape == (8,)
    lp = post.logpost(p)
    assert np.isfinite(float(lp))
    # Sampling runs.
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(1), 4)
    result = run_mcmc(rwm.make_kernel(post.logpost), rwm.make_adapter(),
                      states, rwm.init_hyper(post.prior_scales, 0.1),
                      jax.random.PRNGKey(2), n_warmup=100, n_steps=100)
    assert np.isfinite(np.asarray(result.logpost_trace)).all()


def test_prior_sampling_matches_prior_density_shapes():
    post, _, _ = _events_setup("joint", hierarchical_noise=True)
    keys = jax.random.split(jax.random.PRNGKey(0), 500)
    draws = jax.vmap(post.sample_prior)(keys)
    # u marginal std ~ prior_sigma_u.
    assert abs(np.asarray(draws.u).std() - 0.15) < 0.02
    # hypo_raw is standard logistic: std = pi/sqrt(3) ~ 1.814.
    assert abs(np.asarray(draws.hypo_raw).std() - 1.8138) < 0.12


def test_pcn_api_tomo_smoke():
    """API-level pCN on plain tomo (regression: the pcn proposal used to
    crash on the None params leaves — t0/log_sigma/hypo_raw are None in
    tomo mode, and is_leaf=None-check routes them into propose())."""
    import dataclasses as dc

    from mceik_tpu.api import run
    from mceik_tpu.io.config_io import config_from_dict

    cfg = config_from_dict({
        "grid": {"shape": [12, 12, 12], "spacing": [1.0, 1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-3, "max_iters": 30},
        "model": {"mode": "tomo", "inv_shape": [3, 3, 3],
                  "background_slowness": 1.0, "prior_sigma_u": 0.15,
                  "sigma": 0.05},
        "sampler": {"algorithm": "pcn", "n_chains": 2, "n_warmup": 30,
                    "n_samples": 30, "thin": 2, "step_size": 0.1,
                    "seed": 0},
        "data": {"dataset": "checkerboard3d", "n_src": 3, "n_rec": 4,
                 "noise": 0.05, "seed": 5, "checker_cells": [2, 2, 2],
                 "checker_amplitude": 0.08},
    })
    summary = run(cfg)
    assert 0.0 < summary.accept_rate < 1.0
    assert np.isfinite(summary.post_mean["params"].u).all()
