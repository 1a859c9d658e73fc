"""Trans-dimensional spike-slab noise hyperparameters (SURVEY.md §0
config 5 "trans-dimensional noise hyperparameters"; VERDICT r1 missing #2):
per-station indicators moved by exact Gibbs must recover which stations
are genuinely noisy, and the exact precision-weighted t0 marginalization
must match brute-force numeric integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.api import _wrap_noise_gibbs, spike_slab_warmup
from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.model.posterior import (_marginalized_t0_loglik,
                                       build_posterior)
from mceik_tpu.samplers import am
from mceik_tpu.samplers.base import init_chain_states, run_mcmc

GRID2 = Grid(shape=(17, 17), spacing=(1.0, 1.0))
ECFG = EikonalCfg(method="sweep", tol=1e-4, max_iters=50)

NOISY = (2, 5, 7)  # stations with genuinely inflated noise
SIGMA = 0.005
INFLATE = 12.0


def _eik():
    from mceik_tpu.eikonal.solve import EikonalConfig
    return EikonalConfig(method="sweep", tol=1e-4, max_iters=50)


def _corrupted_tomo(inv_shape=(4, 4)):
    """Crosswell arrivals with 3 stations' noise inflated 12x.

    Homogeneous truth (amplitude 0) so the coarse basis represents it
    exactly — otherwise basis-truncation model error exceeds sigma and
    *every* station is correctly flagged noisy, which tests nothing.
    Each station's noise column is standardized to its exact target RMS:
    the detector's input SNR is then controlled, not seed-luck (a clean
    station whose chi^2_24 draw lands 40% high is *correctly* ambiguous —
    that's inference behaving, but it makes a terrible unit test)."""
    mcfg = ModelCfg(mode="tomo", inv_shape=inv_shape, prior_sigma_u=0.15,
                    sigma=SIGMA, noise_model="spike_slab", noise_p0=0.15,
                    sigma_hyper=1.5)
    dcfg = DataCfg(dataset="crosswell2d", n_src=24, n_rec=10, noise=0.0,
                   seed=21, checker_cells=(2, 2), checker_amplitude=0.0)
    data, truth = make_dataset(GRID2, dcfg, mcfg, _eik())
    rng = np.random.default_rng(99)
    t_obs = np.asarray(data.t_obs).copy()  # noiseless
    for j in range(t_obs.shape[1]):
        eps = rng.standard_normal(t_obs.shape[0])
        eps *= 1.0 / np.sqrt((eps ** 2).mean())  # empirical RMS exactly 1
        t_obs[:, j] += (INFLATE if j in NOISY else 1.0) * SIGMA * eps
    data = data.replace(t_obs=jnp.asarray(t_obs))
    return mcfg, data, truth


@pytest.mark.slow
def test_spike_slab_recovers_noisy_stations():
    """HMC + annealed Gibbs (the config-5 pairing: gradient sampler over
    the continuous block, exact Gibbs over the indicators)."""
    from mceik_tpu.samplers import hmc

    mcfg, data, _ = _corrupted_tomo()
    post = build_posterior(mcfg, data, GRID2, ECFG, differentiable=True)
    assert post.noise_gibbs is not None

    ex = post.init_params(jax.random.PRNGKey(0))
    assert ex.noise_z is not None and ex.noise_z.shape == (10,)
    # Indicators frozen for the continuous kernel.
    assert float(jnp.max(jnp.abs(post.prior_scales.noise_z))) == 0.0

    base = hmc.make_kernel(post.logpost, n_leapfrog=10)
    kernel = _wrap_noise_gibbs(base, post.noise_gibbs)
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(1), 4)
    hyper = hmc.init_hyper(post.prior_scales, 0.02, ex)
    states, hyper = spike_slab_warmup(base, post.noise_gibbs,
                                      hmc.make_adapter(), states, hyper,
                                      jax.random.PRNGKey(7), 300,
                                      finalize_fn=hmc.finalize)
    result = run_mcmc(kernel, None, states, hyper,
                      jax.random.PRNGKey(2), n_warmup=0, n_steps=300)

    # Posterior inclusion probability per station = mean of z draws.
    incl = np.asarray(result.samples.noise_z).mean(axis=(0, 1))
    for j in range(10):
        if j in NOISY:
            assert incl[j] > 0.7, (j, incl)
        else:
            assert incl[j] < 0.3, (j, incl)

    # Active slab values should estimate the actual inflation (~log 12).
    z_draws = np.asarray(result.samples.noise_z)           # (T, C, S)
    ls_draws = np.asarray(result.samples.log_sigma)
    active = z_draws[:, :, NOISY] > 0
    ls_active = ls_draws[:, :, NOISY][active]
    assert abs(np.exp(ls_active.mean()) - INFLATE) / INFLATE < 0.6


def test_spike_slab_gibbs_preserves_logpost_consistency():
    """The (params, log_prior, log_lik) returned by noise_gibbs must equal
    the posterior's own functions evaluated at the returned params."""
    mcfg, data, _ = _corrupted_tomo()
    post = build_posterior(mcfg, data, GRID2, ECFG)
    p = post.init_params(jax.random.PRNGKey(3))
    new, lp_prior, lp_lik = post.noise_gibbs(jax.random.PRNGKey(4), p)
    np.testing.assert_allclose(float(lp_prior), float(post.log_prior(new)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(lp_lik), float(post.log_lik(new)),
                               rtol=1e-5)
    assert set(np.unique(np.asarray(new.noise_z))).issubset({0.0, 1.0})


@pytest.mark.slow
def test_spike_slab_smc_runs_and_flips():
    """SMC with the tempered Gibbs inside mutation: ladder completes and
    the population carries a mix of indicator configurations."""
    from mceik_tpu.samplers.smc import run_smc

    # 2x2 inversion basis: RWM mutation (no gradients) must be able to
    # converge the field within the ladder, else "every station is noisy"
    # is the honest-but-untestable inference for an unconverged field.
    mcfg, data, _ = _corrupted_tomo(inv_shape=(2, 2))
    post = build_posterior(mcfg, data, GRID2, ECFG)
    r = run_smc(post, jax.random.PRNGKey(5), n_particles=256,
                n_mutation_steps=5, step_size=0.3, max_stages=60)
    assert r.betas[-1] == 1.0
    z = np.asarray(r.state.params.noise_z)
    incl = z.mean(axis=0)
    # Noisy stations should dominate inclusion in the final population.
    assert incl[list(NOISY)].mean() > 0.5
    clean = [j for j in range(10) if j not in NOISY]
    assert incl[clean].mean() < 0.4


@pytest.mark.slow
def test_c5_config_runs_reduced_scale():
    """The checked-in c5 pod config runs at reduced scale on the 8-device
    virtual mesh through the production api.run path (VERDICT r1 weak #9:
    c5 was unrunnable as written — multihost init crashed outside a
    cluster — and untested at any scale): joint NUTS + spike-slab noise +
    sharded chains + annealed-Gibbs warmup, end to end."""
    from mceik_tpu.api import run
    from mceik_tpu.io.config_io import apply_overrides, load_config

    cfg = load_config("configs/c5_pod_nuts.json")
    cfg = apply_overrides(cfg, [
        "grid.shape=[12,12,12]", "model.inv_shape=[4,4,4]",
        "sampler.n_chains=8", "sampler.n_warmup=8", "sampler.n_samples=8",
        "sampler.thin=2", "sampler.max_tree_depth=3",
        "data.n_events=2", "data.n_stations=4", "io.log_every=8",
    ])
    assert cfg.dist.multihost  # the pod flag stays on; fallback handles it
    assert cfg.model.resolved_noise_model() == "spike_slab"
    summary = run(cfg, verbose=False)
    assert np.isfinite(summary.accept_rate)
    assert np.isfinite(np.asarray(summary.result.logpost_trace)).all()
    incl = np.asarray(summary.post_mean["params"].noise_z)
    assert incl.shape == (4,)
    assert ((incl >= 0.0) & (incl <= 1.0)).all()


def test_marginalized_t0_matches_numeric_integral():
    """Heteroscedastic per-station sigma: the closed form must equal
    brute-force numeric integration over t0 (up to the flat-prior
    constant sqrt(2 pi))."""
    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.standard_normal((3, 5)), jnp.float32)
    sigma = jnp.asarray([0.5, 1.0, 2.0, 0.7, 1.5], jnp.float32)
    mask = jnp.asarray(rng.random((3, 5)) > 0.2, jnp.float32)

    got = float(_marginalized_t0_loglik(r, sigma, mask))

    t0s = np.linspace(-30, 30, 20001)
    dt = t0s[1] - t0s[0]
    total = 0.0
    for i in range(3):
        ll = -0.5 * np.sum(
            np.asarray(mask[i])[None, :]
            * (np.asarray(r[i])[None, :] - t0s[:, None]) ** 2
            / np.asarray(sigma)[None, :] ** 2, axis=1)
        total += np.log(np.trapezoid(np.exp(ll), dx=dt))
    total += -float(jnp.sum(mask * jnp.log(sigma)))
    # Our form drops the sqrt(2 pi) per event from the Gaussian integral.
    total -= 3 * 0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(got, total, rtol=1e-4, atol=1e-4)
