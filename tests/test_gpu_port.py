"""What running on an NVIDIA GPU asks of the package, checked on CPU:
imports the GPU machine can satisfy, fp32 products pinned to full
precision, one compile-cache rule, no solver option left in the config,
and a smoke script that refuses to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg, RunConfig
from mceik_tpu.io.config_io import apply_overrides, config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_main_path_imports_without_flax_or_h5py():
    code = ("import sys; sys.modules['flax'] = None; "
            "sys.modules['h5py'] = None; "
            "import mceik_tpu.cli, mceik_tpu.api, mceik_tpu.samplers.smc")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_use_pallas_is_an_unknown_config_key():
    with pytest.raises(ValueError, match="use_pallas"):
        config_from_dict({"eikonal": {"use_pallas": "off"}})
    with pytest.raises(ValueError, match="use_pallas"):
        apply_overrides(RunConfig(), ["eikonal.use_pallas=off"])


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_rule(monkeypatch, tmp_path, env_dir):
    from mceik_tpu.cli import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = enable_compile_cache()
            assert path == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            target = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
            assert enable_compile_cache() == target
            # JAX reads the variable itself; the code sets nothing.
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, REPO)
    import chip_smoke

    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.fixture(scope="module")
def small_posterior():
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.posterior import build_posterior

    grid = Grid(shape=(6, 6, 6), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(2, 2, 2), prior_sigma_u=0.15,
                    sigma=0.03)
    dcfg = DataCfg(dataset="checkerboard3d_volume", n_src=2, n_rec=3,
                   noise=0.03, seed=42, checker_cells=(2, 2, 2),
                   checker_amplitude=0.08)
    data, _ = make_dataset(grid, dcfg, mcfg)
    return build_posterior(mcfg, data, grid,
                           EikonalCfg(method="sweep", tol=1e-3, max_iters=5),
                           differentiable=True)


@pytest.mark.parametrize("what", ["mala_step", "gauss_newton_covariance"])
def test_fp32_products_pinned_to_highest(small_posterior, what):
    from mceik_tpu.model.laplace import gauss_newton_covariance
    from mceik_tpu.samplers import mala

    post = small_posterior
    params = post.init_params(jax.random.PRNGKey(0))
    if what == "mala_step":
        states = mala.init_states(post.logpost, post.init_params,
                                  jax.random.PRNGKey(1), 1)
        state = jax.tree.map(lambda x: x[0], states)
        hyper = mala.init_hyper(post.prior_scales, 0.1, params)
        jaxpr = jax.make_jaxpr(mala.make_kernel(post.logpost))(
            jax.random.PRNGKey(2), state, hyper)
    else:
        jaxpr = jax.make_jaxpr(
            lambda p: gauss_newton_covariance(post, p))(params)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert precisions, "no matrix products found"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions
