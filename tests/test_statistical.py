"""Statistical equivalence across samplers (SURVEY.md §4 "Statistical
equivalence", §6 "posterior moments within MC error").

With no published reference numbers (reference mount empty), the strongest
available check is cross-method: RWM (gradient-free MH), HMC (gradients
through the implicit eikonal adjoint) and tempered SMC (importance
sampling + rejuvenation) are three independent inference mechanisms; they
must produce the same posterior moments for the same tiny tomography
posterior. A bias in the adjoint, the likelihood, the tempering or the
resampler would break the agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.samplers import hmc, rwm
from mceik_tpu.samplers.base import init_chain_states, run_mcmc
from mceik_tpu.samplers.smc import run_smc
from mceik_tpu.diag.moments import welford_finalize, welford_merge_chains

# Noise chosen so the posterior is broad enough that ALL samplers mix well
# within test budgets — the test targets cross-method bias, not mixing
# endurance (that's what the e2e recovery tests stress).

pytestmark = pytest.mark.slow

GRID = Grid(shape=(17, 17), spacing=(1.0, 1.0))
MCFG = ModelCfg(mode="tomo", inv_shape=(4, 4), prior_sigma_u=0.15,
                sigma=0.05)
DCFG = DataCfg(dataset="crosswell2d", n_src=3, n_rec=4, noise=0.05,
               seed=11, checker_cells=(2, 2), checker_amplitude=0.08)
ECFG = EikonalCfg(method="sweep", tol=1e-5, max_iters=80)


@pytest.fixture(scope="module")
def posteriors():
    data, _ = make_dataset(GRID, DCFG, MCFG)
    post = build_posterior(MCFG, data, GRID, ECFG)
    post_diff = build_posterior(MCFG, data, GRID, ECFG, differentiable=True)
    return post, post_diff


def _moments(result):
    mean, var = welford_finalize(welford_merge_chains(result.welford))
    return np.asarray(mean.u), np.asarray(var.u)


@pytest.fixture(scope="module")
def rwm_moments(posteriors):
    post, _ = posteriors
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), 8)
    r = run_mcmc(rwm.make_kernel(post.logpost), rwm.make_adapter(),
                 states, rwm.init_hyper(post.prior_scales, 0.05),
                 jax.random.PRNGKey(1), n_warmup=1500, n_steps=6000, thin=6)
    return _moments(r)


def test_hmc_matches_rwm(posteriors, rwm_moments):
    _, post_diff = posteriors
    mean_r, var_r = rwm_moments
    states = init_chain_states(post_diff.logpost, post_diff.init_params,
                               jax.random.PRNGKey(2), 4)
    ex = post_diff.init_params(jax.random.PRNGKey(3))
    r = run_mcmc(hmc.make_kernel(post_diff.logpost, n_leapfrog=10),
                 hmc.make_adapter(), states,
                 hmc.init_hyper(post_diff.prior_scales, 0.02, ex),
                 jax.random.PRNGKey(4), n_warmup=500, n_steps=1200, thin=4,
                 finalize_fn=hmc.finalize)
    mean_h, var_h = _moments(r)
    scale = np.sqrt(var_r) + 0.01
    assert np.max(np.abs(mean_h - mean_r) / scale) < 1.2, (
        np.abs(mean_h - mean_r) / scale)
    # Variances agree within a factor band (MC error on 2nd moments).
    ratio = (var_h + 1e-5) / (var_r + 1e-5)
    assert 0.4 < ratio.min() and ratio.max() < 2.5, ratio


def test_smc_matches_rwm(posteriors, rwm_moments):
    post, _ = posteriors
    mean_r, var_r = rwm_moments
    res = run_smc(post, jax.random.PRNGKey(5), n_particles=2048,
                  n_mutation_steps=8, step_size=0.1)
    u = np.asarray(res.state.params.u).reshape(2048, -1)
    mean_s = u.mean(axis=0).reshape(mean_r.shape)
    var_s = u.var(axis=0).reshape(var_r.shape)
    scale = np.sqrt(var_r) + 0.01
    assert np.max(np.abs(mean_s - mean_r) / scale) < 1.2, (
        np.abs(mean_s - mean_r) / scale)
    ratio = (var_s + 1e-5) / (var_r + 1e-5)
    assert 0.4 < ratio.min() and ratio.max() < 2.5, ratio
    assert res.betas[-1] == 1.0
