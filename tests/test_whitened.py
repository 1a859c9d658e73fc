"""Whitened (Laplace-referenced) reparameterization (model/whitened.py)
+ the samplers it enables: whitened NUTS (== dense-GN-mass NUTS) and
generalized pCN — the VERDICT r4 #2 levers against flagship-scale field
mixing.

Assertions encode what the machinery is FOR, on the same small tomography
posterior as test_laplace.py:
  - the u-space view is an exact reparameterization (logpost_u(u) ==
    logpost(x_map + L u); frozen coords pinned);
  - whitened NUTS mixes the 27-dim posterior far above the per-cell ESS
    estimator floor and its posterior mean agrees with the MAP;
  - gpCN (gradient-free) holds healthy acceptance with moments agreeing
    with the MAP (the Laplace reference absorbs the Gaussian bulk).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.diag.ess import ess_per_param
from mceik_tpu.grid import Grid
from mceik_tpu.model.laplace import laplace_preconditioner
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.model.whitened import whitened_view
from mceik_tpu.samplers import hmc, nuts, pcn
from mceik_tpu.samplers.base import init_chain_states, run_mcmc

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


def _setup():
    post = _post()
    p_map, cov, _ = laplace_preconditioner(post, n_map_steps=100)
    return post, p_map, cov, whitened_view(post, p_map, cov)


def test_whitened_view_is_exact_reparameterization():
    post, p_map, cov, wv = _setup()
    key = jax.random.PRNGKey(3)
    u = wv.init_u(key)
    p = wv.params_of(u)
    np.testing.assert_allclose(float(wv.logpost_u(u)),
                               float(post.logpost(p)), rtol=0, atol=0)
    # u = 0 maps exactly to the MAP.
    p0 = wv.params_of(wv.zero_u)
    np.testing.assert_array_equal(np.asarray(p0.u), np.asarray(p_map.u))
    # the gpCN residual is logpost_u + ||u_active||^2/2
    ua = np.asarray(wv.scales_u) * np.asarray(u)
    np.testing.assert_allclose(
        float(wv.resid_u(u)),
        float(wv.logpost_u(u)) + 0.5 * float((ua * ua).sum()), rtol=1e-6)


@pytest.mark.slow
def test_whitened_nuts_mixes_and_agrees_with_map():
    post, p_map, cov, wv = _setup()
    n_chains = 8
    states = init_chain_states(wv.logpost_u, wv.init_u,
                               jax.random.PRNGKey(0), n_chains)
    hyper = hmc.init_hyper(wv.scales_u, 0.3, wv.zero_u)
    kernel = nuts.make_kernel(wv.logpost_u, max_tree_depth=3)
    result = run_mcmc(kernel, hmc.make_adapter(0.8), states, hyper,
                      jax.random.PRNGKey(1), n_warmup=40, n_steps=120,
                      finalize_fn=hmc.finalize,
                      collect_fn=lambda u: wv.params_of(u).u)

    acc = float(np.mean(np.asarray(result.accept_trace)))
    assert 0.5 < acc <= 1.0, acc

    cell = ess_per_param(np.asarray(result.samples))
    floor = 2.0 * n_chains
    assert cell.min() > 5 * floor, (cell.min(), floor)

    u_mean = np.asarray(result.samples).mean(axis=(0, 1)).ravel()
    u_map = np.asarray(p_map.u).ravel()
    sd = np.sqrt(np.diag(np.asarray(cov))[:u_map.size])
    z = np.abs(u_mean - u_map) / np.maximum(sd, 1e-12)
    assert z.max() < 0.5, z.max()


@pytest.mark.slow
def test_gpcn_accepts_and_agrees_with_map():
    post, p_map, cov, wv = _setup()
    n_chains = 8
    states = init_chain_states(wv.resid_u, wv.init_u,
                               jax.random.PRNGKey(0), n_chains)
    hyper = pcn.init_hyper(wv.scales_u, None, 0.2)
    kernel = pcn.make_kernel(wv.resid_u)
    result = run_mcmc(kernel, pcn.make_adapter(0.234), states, hyper,
                      jax.random.PRNGKey(1), n_warmup=200, n_steps=1500,
                      thin=3, collect_fn=lambda u: wv.params_of(u).u)

    # Near-Gaussian target: the Laplace reference absorbs the bulk, so
    # acceptance stays HIGH even as rho adapts to its cap (an exactly
    # Gaussian target accepts every gpCN proposal at any rho) — high
    # acceptance here is the success mode, not a tuning failure.
    acc = float(np.mean(np.asarray(result.accept_trace)))
    assert acc > 0.3, acc

    cell = ess_per_param(np.asarray(result.samples))
    floor = 2.0 * n_chains
    assert cell.min() > 2 * floor, (cell.min(), floor)

    u_mean = np.asarray(result.samples).mean(axis=(0, 1)).ravel()
    u_map = np.asarray(p_map.u).ravel()
    sd = np.sqrt(np.diag(np.asarray(cov))[:u_map.size])
    z = np.abs(u_mean - u_map) / np.maximum(sd, 1e-12)
    assert z.max() < 0.6, z.max()
