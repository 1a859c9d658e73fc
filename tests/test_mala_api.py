"""API-level coverage of algorithm="mala" (VERDICT r3 weak #3): the
api.py dispatch branch — Laplace setup, pinned covariance, MAP-jittered
chain init — and the spike-slab incompatibility guard, on a shrunken
c2_mala-shaped problem (configs/c2_mala.json is the flagship-scale twin).
"""

import dataclasses

import numpy as np
import pytest

from mceik_tpu import api
from mceik_tpu.config import (DataCfg, EikonalCfg, GridCfg, IOCfg, ModelCfg,
                              RunConfig, SamplerCfg)


def _small_mala_config(**sampler_overrides):
    kw = dict(
        algorithm="mala", precondition="laplace", n_map_steps=25,
        n_chains=2, n_warmup=8, n_samples=24, thin=2, step_size=0.3,
        seed=3)
    kw.update(sampler_overrides)
    sampler = SamplerCfg(**kw)
    return RunConfig(
        grid=GridCfg(shape=(12, 12, 12), spacing=(1.0, 1.0, 1.0)),
        eikonal=EikonalCfg(method="sweep", tol=1e-3, max_iters=30),
        model=ModelCfg(mode="tomo", inv_shape=(3, 3, 3),
                       background_slowness=1.0, prior_sigma_u=0.15,
                       sigma=0.05),
        data=DataCfg(dataset="checkerboard3d_volume", n_src=4, n_rec=5,
                     noise=0.05, seed=42, checker_cells=(2, 2, 2),
                     checker_amplitude=0.08),
        io=IOCfg(log_every=24),
        sampler=sampler)


@pytest.mark.slow
def test_mala_laplace_run_end_to_end():
    cfg = _small_mala_config()
    summary = api.run(cfg, verbose=False)
    # Laplace-preconditioned MALA at the right step scale accepts in a
    # healthy band (0.574 target; wide tolerance for the tiny window).
    assert 0.05 < summary.accept_rate < 0.99, summary.accept_rate
    mean_u = np.asarray(summary.post_mean["params"].u)
    var_u = np.asarray(summary.post_var["params"].u)
    assert np.all(np.isfinite(mean_u)) and np.all(np.isfinite(var_u))
    assert np.all(var_u >= 0)
    assert np.isfinite(summary.ess_logpost) and summary.ess_logpost > 0
    # Chains start MAP-jittered, so even this short window should leave
    # the posterior mean near the basin: logpost stays finite throughout.
    lp = np.asarray(summary.result.logpost_trace)
    assert np.all(np.isfinite(lp))


def test_mala_rejects_spike_slab_noise():
    cfg = _small_mala_config(precondition="none")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, noise_model="spike_slab"))
    with pytest.raises(ValueError, match="spike_slab.*mala|mala.*spike"):
        api.run(cfg, verbose=False)


@pytest.mark.slow
def test_mala_laplace_resume_skips_setup(tmp_path, monkeypatch):
    """Resume path (VERDICT r3 #8): the pinned GN covariance lives inside
    the checkpointed MALA hyper, so a resumed run must NOT recompute the
    Laplace preconditioner — laplace_preconditioner is monkeypatched to
    raise, proving the resume path never calls it — and must keep the
    pinned proposal (count ~ n_prime) from the checkpoint."""
    ckpt = str(tmp_path / "mala.ckpt.h5")
    cfg = _small_mala_config(n_samples=8, n_warmup=4)
    cfg = dataclasses.replace(
        cfg, io=dataclasses.replace(cfg.io, checkpoint_path=ckpt,
                                    checkpoint_every=8, log_every=8))
    api.run(cfg, verbose=False)

    from mceik_tpu.model import laplace as laplace_mod

    def boom(*a, **k):
        raise AssertionError("laplace_preconditioner called on resume")

    monkeypatch.setattr(laplace_mod, "laplace_preconditioner", boom)
    cfg2 = dataclasses.replace(
        cfg, io=dataclasses.replace(cfg.io, checkpoint_path=None,
                                    checkpoint_every=0, resume=ckpt))
    summary = api.run(cfg2, verbose=False)
    assert np.all(np.isfinite(np.asarray(summary.result.logpost_trace)))
    # The restored hyper still carries the pinned covariance count.
    assert float(np.asarray(summary.result.hyper.count)) > 1e5
