"""Laplace/Gauss-Newton preconditioner (model/laplace.py) + preconditioned
MALA on a real (small) tomography posterior: the VERDICT r2 #2 remedy for
per-cell mixing sitting at the ESS estimator floor.

The assertions encode what the preconditioner is FOR:
  - MAP ascent monotonically improves logpost through the adjoint stack;
  - the GN covariance is SPD with unit rows at frozen coords;
  - MALA primed with it mixes near-ideally — per-cell ESS far above the
    n_chains-scale estimator floor in a few hundred steps, at healthy
    acceptance with an O(1) whitened step (only possible if C is actually
    close to the posterior covariance);
  - the posterior mean of the short run agrees with the MAP point (the
    posterior is near-Gaussian; a biased Hastings ratio or a wrong C
    normalization drags the mean off).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.diag.ess import ess_per_param
from mceik_tpu.grid import Grid
from mceik_tpu.model.laplace import (gauss_newton_covariance,
                                     laplace_preconditioner, map_estimate)
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.samplers import mala
from mceik_tpu.samplers.base import run_mcmc

GRID = Grid(shape=(11, 11, 11), spacing=(1.0, 1.0, 1.0))
MCFG = ModelCfg(mode="tomo", inv_shape=(3, 3, 3), prior_sigma_u=0.15,
                sigma=0.03)
DCFG = DataCfg(dataset="checkerboard3d_volume", n_src=5, n_rec=6,
               noise=0.03, seed=42, checker_cells=(2, 2, 2),
               checker_amplitude=0.08)
ECFG = EikonalCfg(method="sweep", tol=1e-3, max_iters=30)


def _post():
    data, _ = make_dataset(GRID, DCFG, MCFG)
    return build_posterior(MCFG, data, GRID, ECFG, differentiable=True)


def test_laplace_preconditioned_mala_mixes_and_agrees_with_map():
    post = _post()
    p_map, cov, trace = laplace_preconditioner(post, n_map_steps=100)
    assert trace[-1] > trace[0] + 5.0, (trace[0], trace[-1])  # logpost rises

    d = post.n_dim
    assert cov.shape == (d, d)
    evals = np.linalg.eigvalsh(np.asarray(cov, np.float64))
    assert evals.min() > 0, evals.min()

    n_chains = 8
    # Overdispersed init AROUND the MAP so mixing (not burn-in) is tested.
    def init(key):
        eps = jax.random.normal(key, (d,), jnp.float32)
        x = mala._ravel(p_map) + 2.0 * (
            jnp.asarray(np.linalg.cholesky(np.asarray(cov, np.float64)),
                        jnp.float32) @ eps)
        return mala._unravel_fn(p_map)(x)

    states = mala.init_states(post.logpost, init, jax.random.PRNGKey(0),
                              n_chains)
    hyper = mala.prime_covariance(
        mala.init_hyper(post.prior_scales, 0.4, p_map), cov)
    result = run_mcmc(mala.make_kernel(post.logpost),
                      mala.make_adapter(adapt_cov=False),
                      states, hyper, jax.random.PRNGKey(1),
                      n_warmup=100, n_steps=400, collect_fn=lambda p: p.u)

    acc = float(np.mean(np.asarray(result.accept_trace)))
    assert 0.3 < acc < 0.9, acc

    cell = ess_per_param(np.asarray(result.samples))
    floor = 2.0 * n_chains
    assert cell.min() > 5 * floor, (cell.min(), floor)

    u_mean = np.asarray(result.samples).mean(axis=(0, 1)).ravel()
    u_map = np.asarray(p_map.u).ravel()
    sd = np.sqrt(np.diag(np.asarray(cov))[:u_map.size])
    # Near-Gaussian posterior: mean within a fraction of a posterior sd
    # of the MAP, uniformly over cells (MC error at ESS ~ hundreds is
    # ~0.1 sd; 0.5 leaves room for mild non-Gaussian skew).
    z = np.abs(u_mean - u_map) / np.maximum(sd, 1e-12)
    assert z.max() < 0.5, z.max()


def test_gauss_newton_covariance_freezes_zero_scale_coords():
    """Spike-slab indicator convention: scale-0 coords get unit diagonal,
    zero cross terms, and the active block is unaffected by their
    presence."""
    data, _ = make_dataset(GRID, DCFG, MCFG)
    mcfg = ModelCfg(mode="tomo", inv_shape=(3, 3, 3), prior_sigma_u=0.15,
                    sigma=0.03, noise_model="spike_slab")
    post = build_posterior(mcfg, data, GRID, ECFG, differentiable=True)
    p0, _ = map_estimate(post, n_steps=25)
    cov = np.asarray(gauss_newton_covariance(post, p0))
    scales = np.asarray(mala._ravel(post.prior_scales))
    frozen = np.where(scales == 0)[0]
    assert frozen.size > 0
    for i in frozen:
        np.testing.assert_allclose(cov[i, i], 1.0)
        off = np.delete(cov[i], i)
        np.testing.assert_allclose(off, 0.0, atol=1e-12)
