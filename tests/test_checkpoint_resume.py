"""Fault-injection-style checkpoint/resume through the full API
(SURVEY.md §5 "Failure detection / checkpoint-based recovery"): a run that
"crashes" after writing a checkpoint resumes from it (warmup skipped,
adaptation state restored) and completes with sane statistics."""

import numpy as np

from mceik_tpu.api import run
from mceik_tpu.io.config_io import config_from_dict


def _cfg(tmp_path, **io_kw):
    return config_from_dict({
        "grid": {"shape": [17, 17], "spacing": [1.0, 1.0]},
        "eikonal": {"method": "sweep", "tol": 1e-4, "max_iters": 50},
        "model": {"mode": "tomo", "inv_shape": [4, 4],
                  "background_slowness": 1.0, "prior_sigma_u": 0.2,
                  "sigma": 0.01},
        "sampler": {"algorithm": "rwm", "n_chains": 4, "n_warmup": 500,
                    "n_samples": 200, "thin": 2, "step_size": 0.05,
                    "seed": 3},
        "data": {"dataset": "crosswell2d", "n_src": 3, "n_rec": 4,
                 "noise": 0.01, "seed": 7, "checker_cells": [2, 2],
                 "checker_amplitude": 0.1},
        "io": {"log_every": 50, **io_kw},
    })


def test_checkpoint_then_resume(tmp_path):
    ckpt = str(tmp_path / "run.h5")
    # First run writes periodic checkpoints ("crash" = just stop).
    cfg1 = _cfg(tmp_path, checkpoint_path=ckpt, checkpoint_every=100)
    s1 = run(cfg1, verbose=False)
    assert np.isfinite(s1.post_mean["params"].u).all()
    assert 0.05 < s1.accept_rate < 0.7, s1.accept_rate

    # Resume: warmup must be skipped, adaptation state restored.
    cfg2 = _cfg(tmp_path, resume=ckpt)
    s2 = run(cfg2, verbose=False)
    assert np.isfinite(s2.post_mean["params"].u).all()
    # The resumed run continues from an adapted state: its acceptance rate
    # should be in the adapted band immediately (no warmup happened).
    assert 0.05 < s2.accept_rate < 0.7, s2.accept_rate
    # Adapted step size carried over (not the config default).
    from mceik_tpu.api import _step_size_of
    assert abs(_step_size_of(s2.result.hyper) - _step_size_of(s1.result.hyper)) < 1e-6


def test_segmented_equals_single_run_moments(tmp_path):
    """Segmentation (log_every) must not change the collected statistics:
    same seed, different segmentation -> identical sample trace."""
    a = run(_cfg(tmp_path, log_every=50), verbose=False)
    b = run(_cfg(tmp_path, log_every=200), verbose=False)
    # Keys are derived per segment, so traces differ in randomness — but
    # welford counts and shapes must agree, and moments must agree within
    # MC error.
    assert float(a.result.welford.count[0]) == float(b.result.welford.count[0])
    np.testing.assert_allclose(a.post_mean["params"].u,
                               b.post_mean["params"].u, atol=0.15)
