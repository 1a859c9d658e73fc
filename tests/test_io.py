"""Config round-trip / overrides and checkpoint save-load tests
(SURVEY.md §5 config + checkpoint subsystems)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.config import RunConfig
from mceik_tpu.io.checkpoint import load_checkpoint, save_checkpoint
from mceik_tpu.io.config_io import (apply_overrides, config_from_dict,
                                    config_to_dict, load_config, save_config)
from mceik_tpu.model.params import Params


def test_config_roundtrip(tmp_path):
    cfg = RunConfig()
    p = tmp_path / "cfg.json"
    save_config(cfg, str(p))
    cfg2 = load_config(str(p))
    assert cfg == cfg2


def test_config_overrides():
    cfg = RunConfig()
    cfg2 = apply_overrides(cfg, ["sampler.n_chains=16", "model.mode=joint",
                                 "grid.shape=[9,9,9]"])
    assert cfg2.sampler.n_chains == 16
    assert cfg2.model.mode == "joint"
    assert cfg2.grid.shape == (9, 9, 9)
    # unknown key rejected
    import pytest
    with pytest.raises(ValueError):
        apply_overrides(cfg, ["sampler.bogus=1"])


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": Params(u=jnp.arange(6.0).reshape(2, 3),
                         hypo_raw=None, t0=jnp.ones(4), log_sigma=None),
        "key": jax.random.PRNGKey(7),
        "count": jnp.asarray(3),
    }
    path = str(tmp_path / "ckpt.h5")
    save_checkpoint(path, state, meta={"step": 3})
    example = jax.tree.map(jnp.zeros_like, state)
    restored, meta = load_checkpoint(path, example)
    assert meta["step"] == 3
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_traveltime_table_cache(tmp_path):
    import jax.numpy as jnp
    from mceik_tpu.eikonal.solve import EikonalConfig
    from mceik_tpu.forward.tables_cache import cached_traveltime_tables
    from mceik_tpu.grid import Grid

    grid = Grid(shape=(13, 11), spacing=(1.0, 1.0))
    s = jnp.ones(grid.shape)
    sta = jnp.asarray([[2.0, 3.0], [10.0, 8.0]], jnp.float32)
    cfg = EikonalConfig(method="sweep", tol=1e-5, max_iters=60)
    t1 = cached_traveltime_tables(s, sta, grid, cfg, cache_dir=str(tmp_path))
    files = list(tmp_path.glob("tables_*.h5"))
    assert len(files) == 1
    t2 = cached_traveltime_tables(s, sta, grid, cfg, cache_dir=str(tmp_path))
    np.testing.assert_array_equal(t1, t2)
    # Different slowness -> different cache entry (no stale serving).
    t3 = cached_traveltime_tables(1.1 * s, sta, grid, cfg,
                                  cache_dir=str(tmp_path))
    assert len(list(tmp_path.glob("tables_*.h5"))) == 2
    assert not np.allclose(t1, t3)
