"""Observed-data ingestion (SURVEY.md §1 L5): HDF5 + CSV station/arrival
tables round-trip through io/loaders.py, feed the identical posterior path
as synthetic data, and locate mode runs over a *given* heterogeneous
velocity model with the on-disk table cache."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.datasets.synthetic import checkerboard_slowness, events_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.io.loaders import (load_arrivals_csv, load_dataset_hdf5,
                                  load_events_csv, load_slowness_hdf5,
                                  save_dataset_hdf5, save_events_csv,
                                  save_slowness_hdf5)
from mceik_tpu.model.data import EventData, TomoData
from mceik_tpu.model.params import box_from_raw
from mceik_tpu.model.posterior import build_posterior

GRID2 = Grid(shape=(17, 17), spacing=(1.0, 1.0))
GRID3 = Grid(shape=(17, 17, 13), spacing=(1.0, 1.0, 1.0))
ECFG = EikonalCfg(method="sweep", tol=1e-4, max_iters=50)


def _eik():
    from mceik_tpu.eikonal.solve import EikonalConfig
    return EikonalConfig(method="sweep", tol=1e-4, max_iters=50)


def test_tomo_hdf5_roundtrip_and_file_dataset(tmp_path):
    """Synthetic-written HDF5 file loads back bit-identical through the
    DataCfg.dataset="file" production path, truth model included."""
    mcfg = ModelCfg(mode="tomo", inv_shape=(4, 4), prior_sigma_u=0.15)
    dcfg = DataCfg(dataset="crosswell2d", n_src=4, n_rec=6, noise=0.005,
                   checker_cells=(2, 2), checker_amplitude=0.1)
    data, truth = make_dataset(GRID2, dcfg, mcfg, _eik())

    path = str(tmp_path / "obs.h5")
    save_dataset_hdf5(path, data, slowness=truth["slowness"], grid=GRID2)

    fcfg = DataCfg(dataset="file", path=path)
    data2, truth2 = make_dataset(GRID2, fcfg, mcfg, _eik())
    assert isinstance(data2, TomoData)
    np.testing.assert_array_equal(np.asarray(data2.t_obs),
                                  np.asarray(data.t_obs))
    np.testing.assert_array_equal(np.asarray(data2.src_xyz),
                                  np.asarray(data.src_xyz))
    np.testing.assert_array_equal(np.asarray(truth2["slowness"]),
                                  np.asarray(truth["slowness"]))

    # The file-backed dataset drives the same posterior machinery.
    post = build_posterior(mcfg, data2, GRID2, ECFG)
    lp = post.logpost(post.init_params(jax.random.PRNGKey(0)))
    assert np.isfinite(float(lp))


def test_events_hdf5_roundtrip_with_mask(tmp_path):
    mcfg = ModelCfg(mode="locate")
    dcfg = DataCfg(dataset="events3d", n_events=3, n_stations=6, noise=0.005,
                   seed=3, checker_cells=(2, 2, 2), checker_amplitude=0.0)
    data, _ = make_dataset(GRID3, dcfg, mcfg, _eik())
    mask = np.ones_like(np.asarray(data.t_obs))
    mask[0, 2] = mask[2, 5] = 0.0
    data = EventData(sta_xyz=data.sta_xyz, t_obs=data.t_obs,
                     mask=jnp.asarray(mask))

    path = str(tmp_path / "events.h5")
    save_dataset_hdf5(path, data)
    data2, truth2 = load_dataset_hdf5(path)
    assert isinstance(data2, EventData)
    assert truth2 == {}
    np.testing.assert_array_equal(np.asarray(data2.mask), mask)
    np.testing.assert_array_equal(np.asarray(data2.t_obs),
                                  np.asarray(data.t_obs))


def test_events_csv_roundtrip_with_missing_picks(tmp_path):
    """CSV station/arrival tables: missing picks become mask=0; round-trip
    preserves times, geometry, and the mask."""
    mcfg = ModelCfg(mode="locate")
    dcfg = DataCfg(dataset="events3d", n_events=4, n_stations=5, noise=0.005,
                   seed=11, checker_cells=(2, 2, 2), checker_amplitude=0.0)
    data, _ = make_dataset(GRID3, dcfg, mcfg, _eik())
    mask = np.ones_like(np.asarray(data.t_obs))
    mask[1, 0] = mask[3, 4] = mask[0, 2] = 0.0
    data = EventData(sta_xyz=data.sta_xyz, t_obs=data.t_obs,
                     mask=jnp.asarray(mask))

    sp, ap = str(tmp_path / "stations.csv"), str(tmp_path / "arrivals.csv")
    save_events_csv(sp, ap, data)
    data2 = load_events_csv(sp, ap)
    np.testing.assert_array_equal(np.asarray(data2.mask), mask)
    np.testing.assert_allclose(np.asarray(data2.sta_xyz),
                               np.asarray(data.sta_xyz), rtol=1e-6)
    got = np.asarray(data2.t_obs) * mask
    want = np.asarray(data.t_obs) * mask
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # The csv dataset flows through make_dataset too.
    ccfg = DataCfg(dataset="csv", stations_path=sp, arrivals_path=ap)
    data3, truth3 = make_dataset(GRID3, ccfg, mcfg, _eik())
    assert truth3 == {}
    np.testing.assert_array_equal(np.asarray(data3.t_obs),
                                  np.asarray(data2.t_obs))


def test_csv_loader_rejects_bad_tables(tmp_path):
    sp = tmp_path / "stations.csv"
    sp.write_text("station,x,y,z\nA,0,0,0\nB,1,0,0\n")
    ap = tmp_path / "arrivals.csv"
    ap.write_text("event,station,time\nE1,A,1.0\nE1,C,2.0\n")
    with pytest.raises(ValueError, match="unknown station"):
        load_events_csv(str(sp), str(ap))
    ap.write_text("event,station,time\nE1,A,1.0\nE1,A,2.0\n")
    with pytest.raises(ValueError, match="duplicate pick"):
        load_events_csv(str(sp), str(ap))


def test_locate_over_heterogeneous_fixed_model(tmp_path):
    """Locate mode over a *given* heterogeneous slowness model loaded from
    file, with the HDF5 traveltime-table cache wired in (VERDICT r1
    missing #7): hypocenters recover, and the second build hits the
    cache."""
    from mceik_tpu.samplers import hmc
    from mceik_tpu.samplers.base import init_chain_states, run_mcmc

    # Heterogeneous truth (checkerboard, amplitude 0.12) generates the
    # arrivals; the same field is the fixed locate model.
    dcfg = DataCfg(dataset="events3d", n_events=3, n_stations=8, noise=0.005,
                   seed=7, checker_cells=(2, 2, 2), checker_amplitude=0.12)
    mcfg0 = ModelCfg(mode="locate")
    data, truth = make_dataset(GRID3, dcfg, mcfg0, _eik())

    spath = str(tmp_path / "model.h5")
    save_slowness_hdf5(spath, np.asarray(truth["slowness"]), GRID3)
    np.testing.assert_allclose(load_slowness_hdf5(spath, GRID3),
                               np.asarray(truth["slowness"]))

    cache_dir = str(tmp_path / "tables")
    mcfg = ModelCfg(mode="locate", fixed_slowness_path=spath,
                    table_cache_dir=cache_dir)
    post = build_posterior(mcfg, data, GRID3, ECFG)
    cache_files = os.listdir(cache_dir)
    assert len(cache_files) == 1 and cache_files[0].startswith("tables_")

    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), 4)
    ex = post.init_params(jax.random.PRNGKey(1))
    result = run_mcmc(
        hmc.make_kernel(post.logpost, n_leapfrog=10), hmc.make_adapter(),
        states, hmc.init_hyper(post.prior_scales, 0.05, ex),
        jax.random.PRNGKey(2), n_warmup=400, n_steps=600,
        finalize_fn=hmc.finalize)
    raw_mean = np.asarray(result.welford.mean.hypo_raw).mean(axis=0)
    hypo_mean = np.asarray(box_from_raw(jnp.asarray(raw_mean), GRID3))
    err = np.linalg.norm(hypo_mean - np.asarray(truth["hypo"]), axis=-1)
    assert err.max() < 2.0, (hypo_mean, np.asarray(truth["hypo"]))

    # Second build must *load* the cached tables (no new file, same count).
    post2 = build_posterior(mcfg, data, GRID3, ECFG)
    assert os.listdir(cache_dir) == cache_files
    p = post.init_params(jax.random.PRNGKey(5))
    np.testing.assert_allclose(float(post.logpost(p)),
                               float(post2.logpost(p)), rtol=1e-6)
