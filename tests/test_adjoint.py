"""Gradient tests for the implicit-adjoint differentiable eikonal solve
(SURVEY.md §4 "Unit: model" — 'jax.grad vs finite differences on tiny
grids (validates the adjoint!)')."""

import jax
import jax.numpy as jnp
import numpy as np

from mceik_tpu.grid import Grid
from mceik_tpu.eikonal.solve import EikonalConfig
from mceik_tpu.eikonal.adjoint import solve_eikonal_diff

CFG = EikonalConfig(method="sweep", tol=1e-7, max_iters=200)


def _smooth_slowness(key, grid, amp=0.25):
    u = jax.random.normal(key, (4,) * grid.ndim)
    u = jax.image.resize(u, grid.shape, method="linear")
    return jnp.exp(amp * u)


def test_grad_matches_fd_2d():
    grid = Grid(shape=(13, 13), spacing=(1.0, 1.0))
    s = _smooth_slowness(jax.random.PRNGKey(0), grid)
    src = jnp.asarray([2.0, 3.0], jnp.float32)
    # Weighted sum of the field at all nodes = generic linear functional.
    w = jax.random.normal(jax.random.PRNGKey(1), grid.shape)

    def loss(s_):
        return jnp.sum(w * solve_eikonal_diff(s_, src, grid, CFG))

    g = np.asarray(jax.grad(loss)(s))
    assert np.isfinite(g).all()

    rng = np.random.default_rng(0)
    idxs = [tuple(rng.integers(1, 12, size=2)) for _ in range(6)]
    eps = 3e-3
    for ij in idxs:
        e = jnp.zeros(grid.shape).at[ij].set(1.0)
        fd = (loss(s + eps * e) - loss(s - eps * e)) / (2 * eps)
        fd = float(fd)
        if abs(fd) < 1e-3 and abs(g[ij]) < 1e-3:
            continue
        rel = abs(g[ij] - fd) / max(abs(fd), abs(g[ij]), 1e-6)
        assert rel < 0.08, (ij, float(g[ij]), fd, rel)


def test_grad_receiver_functional_3d():
    """Gradient of an interpolated receiver time w.r.t. slowness: nonzero
    along the ray corridor, near-zero far from it, FD-consistent."""
    from mceik_tpu.forward.predict import interp_at

    grid = Grid(shape=(11, 11, 11), spacing=(1.0, 1.0, 1.0))
    s = _smooth_slowness(jax.random.PRNGKey(2), grid, amp=0.15)
    src = jnp.asarray([1.0, 5.0, 5.0], jnp.float32)
    rec = jnp.asarray([9.0, 5.0, 5.0], jnp.float32)

    def t_rec(s_):
        T = solve_eikonal_diff(s_, src, grid, CFG)
        return interp_at(T, rec, grid)

    g = np.asarray(jax.grad(t_rec)(s))
    assert np.isfinite(g).all()
    # Traveltime increases with slowness along the corridor.
    assert g.sum() > 0
    # FD spot-check at a mid-ray voxel.
    eps = 3e-3
    e = jnp.zeros(grid.shape).at[5, 5, 5].set(1.0)
    fd = float((t_rec(s + eps * e) - t_rec(s - eps * e)) / (2 * eps))
    rel = abs(float(g[5, 5, 5]) - fd) / max(abs(fd), 1e-6)
    assert rel < 0.1, (float(g[5, 5, 5]), fd, rel)


def test_grad_through_tomo_likelihood():
    """End-to-end: grad of the Gaussian traveltime likelihood w.r.t. the
    coarse log-slowness field (resize+exp+solve+interp chain)."""
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.model.posterior import build_posterior

    grid = Grid(shape=(13, 13), spacing=(1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(4, 4), prior_sigma_u=0.2,
                    sigma=0.01)
    dcfg = DataCfg(dataset="crosswell2d", n_src=3, n_rec=4, noise=0.01,
                   checker_cells=(2, 2), checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-7, max_iters=200)
    data, _ = make_dataset(grid, dcfg, mcfg)
    post = build_posterior(mcfg, data, grid, ecfg, differentiable=True)
    params = post.init_params(jax.random.PRNGKey(0))

    lp, g = jax.value_and_grad(post.logpost)(params)
    gu = np.asarray(g.u)
    assert np.isfinite(float(lp)) and np.isfinite(gu).all()

    eps = 1e-3
    e = jnp.zeros(mcfg.inv_shape).at[2, 1].set(1.0)
    lp_p = post.logpost(params.replace(u=params.u + eps * e))
    lp_m = post.logpost(params.replace(u=params.u - eps * e))
    fd = float((lp_p - lp_m) / (2 * eps))
    rel = abs(gu[2, 1] - fd) / max(abs(fd), abs(gu[2, 1]), 1e-6)
    assert rel < 0.1, (gu[2, 1], fd, rel)
