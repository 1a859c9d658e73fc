"""pCN kernel on a conjugate Gaussian target + grid-search locate
(SURVEY.md §2.1 rows "Adaptive Metropolis" (pCN upgrade) and "Hypocenter
grid-search / locate mode")."""

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.samplers import pcn
from mceik_tpu.samplers.base import run_mcmc
from mceik_tpu.diag.moments import welford_finalize, welford_merge_chains

SIGMA = 0.5
OBS = np.array([1.0, -1.0])


def test_pcn_gaussian_moments():
    """Prior N(0, I), Gaussian likelihood -> closed-form posterior. The
    pCN chain (likelihood-only acceptance) must recover it."""

    def log_lik(x):
        return -0.5 * jnp.sum((jnp.asarray(OBS, jnp.float32) - x) ** 2) / SIGMA**2

    keys = jax.random.split(jax.random.PRNGKey(0), 8)
    params = jax.vmap(lambda k: jax.random.normal(k, (2,), jnp.float32))(keys)
    states = jax.vmap(lambda p: pcn.init_state(log_lik, p))(params)

    hyper = pcn.init_hyper(gauss_scales=jnp.ones(2), rw_scales=None, rho=0.3)
    r = run_mcmc(pcn.make_kernel(log_lik), pcn.make_adapter(),
                 states, hyper, jax.random.PRNGKey(1),
                 n_warmup=500, n_steps=4000)
    mean, var = welford_finalize(welford_merge_chains(r.welford))
    prec = 1.0 + 1.0 / SIGMA**2
    np.testing.assert_allclose(np.asarray(mean), OBS * (1 / SIGMA**2) / prec,
                               atol=0.1)
    np.testing.assert_allclose(np.asarray(var), np.full(2, 1 / prec),
                               rtol=0.35)
    acc = float(np.mean(np.asarray(r.accept_trace)))
    assert 0.1 < acc < 0.6, acc


def test_locate_grid_search_recovers_events():
    from mceik_tpu.config import DataCfg, ModelCfg
    from mceik_tpu.datasets import events_dataset
    from mceik_tpu.eikonal.solve import EikonalConfig
    from mceik_tpu.forward.locate import locate_grid_search
    from mceik_tpu.forward.predict import traveltime_tables
    from mceik_tpu.grid import Grid

    grid = Grid(shape=(17, 17, 13), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="locate", background_slowness=1.0)
    dcfg = DataCfg(dataset="events3d", n_events=4, n_stations=9,
                   noise=0.003, seed=3, checker_cells=(2, 2, 2),
                   checker_amplitude=0.0)
    eik = EikonalConfig(method="sweep", tol=1e-5, max_iters=80)
    data, s_true, hypo_true, t0_true = events_dataset(grid, dcfg, mcfg, eik)

    tables = traveltime_tables(jnp.ones(grid.shape), data.sta_xyz, grid, eik)
    out = locate_grid_search(tables, data.t_obs, grid, sigma=dcfg.noise)
    err = np.linalg.norm(np.asarray(out["hypo"]) - np.asarray(hypo_true),
                         axis=-1)
    # Grid search resolves to the nearest node (cell diagonal ~1.73) plus
    # first-order solver bias.
    assert err.max() < 2.5, (np.asarray(out["hypo"]), np.asarray(hypo_true))
    # t0 alone is NOT identifiable to high precision (classic
    # depth/origin-time tradeoff under a surface array): check the fit
    # instead — predicted arrivals at the estimate must match t_obs to
    # node-snap accuracy.
    from mceik_tpu.forward.predict import predict_events
    t_pred = predict_events(tables, jnp.asarray(out["hypo"]),
                            jnp.asarray(out["t0"]), grid)
    resid = np.asarray(t_pred) - np.asarray(data.t_obs)
    assert np.sqrt((resid ** 2).mean()) < 0.3, resid
