"""Golden cross-check: the independently-implemented C++ serial FSM oracle
(native/fsm.cc — the reference's own algorithm family) must agree with the
parallel JAX solvers on the same discrete fixed point (SURVEY.md §4
"Unit: eikonal", §5 race-detection analog)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.grid import Grid
from mceik_tpu.eikonal import EikonalConfig, solve_eikonal
from mceik_tpu.native import fsm_solve, have_native


@pytest.fixture(autouse=True)
def _native():
    # Decided per test, not at import: every test worker imports this
    # module, and the library is built on first use.
    if not have_native():
        pytest.skip("g++ unavailable / build failed")


def _smooth(key, grid, amp=0.3):
    u = jax.random.normal(key, (5,) * grid.ndim)
    u = jax.image.resize(u, grid.shape, method="linear")
    return jnp.exp(amp * u)


@pytest.mark.parametrize("shape", [(33, 29), (17, 15, 13)])
def test_cpp_fsm_matches_jax(shape):
    grid = Grid(shape=shape, spacing=tuple(1.0 for _ in shape))
    s = _smooth(jax.random.PRNGKey(5), grid)
    src = jnp.asarray([3.0] * len(shape), jnp.float32)
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=200)
    T_jax = np.asarray(solve_eikonal(s, src, grid, cfg))
    T_cpp, n_passes = fsm_solve(np.asarray(s), np.asarray(src), grid,
                                tol=1e-8, max_passes=100)
    assert n_passes >= 1
    np.testing.assert_allclose(T_cpp, T_jax, atol=2e-3)


def test_cpp_fsm_anisotropic():
    grid = Grid(shape=(25, 19), spacing=(0.5, 1.0), origin=(1.0, -2.0))
    s = jnp.ones(grid.shape)
    src = jnp.asarray([6.0, 5.0], jnp.float32)  # physical, inside grid
    cfg = EikonalConfig(method="sweep", tol=1e-6, max_iters=200)
    T_jax = np.asarray(solve_eikonal(s, src, grid, cfg))
    T_cpp, _ = fsm_solve(np.ones(grid.shape, np.float32), np.asarray(src),
                         grid, tol=1e-8)
    np.testing.assert_allclose(T_cpp, T_jax, atol=2e-3)
