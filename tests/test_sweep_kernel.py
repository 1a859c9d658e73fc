"""GPU sweep kernel (eikonal/sweep_kernel.py) and the batched solve's
routing (eikonal/batched.py).

The kernel runs here in the Pallas interpreter: it must reproduce the
plain XLA sweep (``solve._sweep_solve``) — the same arithmetic in the same
order, so agreement is exact up to fp32 rounding — on cube, padded,
anisotropic and off-node problems, with each field of a batch stopping at
its own cycle count. Its compiled form runs on the card in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from mceik_tpu.eikonal import batched, sweep_kernel
from mceik_tpu.eikonal.solve import (EikonalConfig, _sweep_cycle,
                                     _sweep_solve, seed_source)
from mceik_tpu.grid import Grid

TRITON_CALL = "__gpu$xla.gpu.triton"


def _fields(grid, srcs, n_coarse=5, amp=0.3, seed=0):
    u = jax.random.normal(jax.random.PRNGKey(seed),
                          (len(srcs),) + (n_coarse,) * 3)
    s = jnp.exp(amp * jax.vmap(
        lambda x: jax.image.resize(x, grid.shape, "linear"))(u))
    srcs = jnp.asarray(srcs, jnp.float32)
    T0, frozen = jax.vmap(lambda x, sf: seed_source(sf, x, grid, 3.0))(srcs, s)
    return T0, frozen, s


def _reference(grid, T0, frozen, s, tol, n_inner=2, max_cycles=100):
    return jax.vmap(lambda a, b, c: _sweep_solve(
        a, b, c, grid.spacing, tol, max_cycles, n_inner))(T0, frozen, s)


def _kernel(grid, T0, frozen, s, tol, n_inner=2, max_cycles=100):
    return sweep_kernel.sweep_solve_batched(
        T0, jnp.where(frozen, T0, 0.0), s, grid.spacing, tol, max_cycles,
        n_inner, interpret=True)


def _cycles(grid, T0, frozen, s, tol, n_inner=2, max_cycles=100):
    """Per-field cycle counts of the reference's stopping rule."""
    def one(T0, fr, s):
        def body(c):
            T, _, k = c
            Tn = _sweep_cycle(T, fr, T0, s, grid.spacing, n_inner)
            return Tn, jnp.max(jnp.abs(Tn - T)), k + 1
        return lax.while_loop(lambda c: (c[1] > tol) & (c[2] < max_cycles),
                              body, (T0, jnp.float32(jnp.inf), 0))[2]
    return np.asarray(jax.vmap(one)(T0, frozen, s))


PROBLEMS = {
    "cube": ((12, 12, 12), (1.0, 1.0, 1.0), [[3.0, 4.0, 5.0],
                                             [9.0, 2.0, 7.0]]),
    "odd_padded": ((17, 19, 21), (1.0, 1.0, 1.0), [[3.0, 3.0, 3.0]]),
    "anisotropic": ((10, 12, 9), (1.0, 1.5, 0.7), [[4.0, 6.0, 2.8],
                                                   [1.0, 1.5, 0.7]]),
    "off_node_source": ((11, 9, 13), (1.0, 1.0, 1.0), [[5.37, 2.71, 8.19]]),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_kernel_matches_reference(name):
    shape, spacing, srcs = PROBLEMS[name]
    grid = Grid(shape=shape, spacing=spacing)
    T0, frozen, s = _fields(grid, srcs)
    ref = _reference(grid, T0, frozen, s, 1e-6)
    out = _kernel(grid, T0, frozen, s, 1e-6)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_kernel_per_field_stopping():
    """A homogeneous field and a rough one converge at different cycle
    counts; each must stop at its own, so the batched solve equals the
    single-field solves exactly."""
    grid = Grid(shape=(12, 10, 14), spacing=(1.0, 1.0, 1.0))
    srcs = [[6.0, 5.0, 7.0], [0.5, 0.5, 13.0]]
    T0, frozen, s = _fields(grid, srcs, amp=0.8, seed=4)
    s = s.at[0].set(1.0)
    T0, frozen = jax.vmap(lambda x, sf: seed_source(sf, x, grid, 3.0))(
        jnp.asarray(srcs, jnp.float32), s)
    tol = 1e-4
    cycles = _cycles(grid, T0, frozen, s, tol)
    assert cycles[0] != cycles[1], cycles
    out = _kernel(grid, T0, frozen, s, tol)
    for i in range(2):
        single = _kernel(grid, T0[i:i + 1], frozen[i:i + 1], s[i:i + 1], tol)
        np.testing.assert_array_equal(np.asarray(out[i]),
                                      np.asarray(single[0]))
    ref = _reference(grid, T0, frozen, s, tol)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("n_inner", [1, 3])
def test_kernel_n_inner(n_inner):
    grid = Grid(shape=(8, 9, 7), spacing=(1.0, 1.0, 1.0))
    T0, frozen, s = _fields(grid, [[2.0, 3.0, 4.0]], seed=2)
    ref = _reference(grid, T0, frozen, s, 1e-6, n_inner=n_inner)
    out = _kernel(grid, T0, frozen, s, 1e-6, n_inner=n_inner)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("n_inner", [1, 2])
def test_kernel_chunked_planes(monkeypatch, n_inner):
    """Planes larger than one register tile (the 128^3 case) march in row
    chunks; shrink the tile so a small problem takes that path."""
    monkeypatch.setattr(sweep_kernel, "CHUNK", 32)
    grid = Grid(shape=(9, 10, 11), spacing=(1.0, 1.0, 1.0))
    assert sweep_kernel._tiling(10, 11)[2] > 1
    T0, frozen, s = _fields(grid, [[2.0, 3.0, 4.0]], seed=3)
    ref = _reference(grid, T0, frozen, s, 1e-6, n_inner=n_inner)
    out = sweep_kernel.sweep_solve_batched.__wrapped__(
        T0, jnp.where(frozen, T0, 0.0), s, grid.spacing, 1e-6, 100, n_inner,
        interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_kernel_zero_cycles_returns_seed():
    grid = Grid(shape=(6, 6, 6), spacing=(1.0, 1.0, 1.0))
    T0, frozen, s = _fields(grid, [[2.0, 2.0, 2.0]])
    out = _kernel(grid, T0, frozen, s, 1e-6, max_cycles=0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(T0))


@pytest.mark.parametrize("plane,expect", [
    ((64, 64), (64, 64, 1)),        # c2: one register tile per plane
    ((48, 32), (64, 32, 1)),        # c3: rows padded to a power of two
    ((128, 128), (32, 128, 4)),     # c5: row chunks
    ((19, 21), (32, 32, 1)),
])
def test_tiling(plane, expect):
    assert sweep_kernel._tiling(*plane) == expect


# ---------------------------------------------------------------------------
# routing and the flat-batch boundary
# ---------------------------------------------------------------------------

def _lowered(grid, cfg, platform):
    srcs = jnp.ones((2, grid.ndim), jnp.float32)
    s = jnp.ones((3,) + grid.shape, jnp.float32)
    f = jax.jit(lambda s: jax.vmap(
        lambda si: batched.solve_eikonal_batched(si, srcs, grid, cfg))(s))
    return f.trace(s).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,shape,method,kernel", [
    ("cuda", (8, 8, 8), "sweep", True),
    ("cpu", (8, 8, 8), "sweep", False),
    ("cuda", (8, 8), "sweep", False),          # 2-D: plain XLA everywhere
    ("cuda", (8, 8, 8), "jacobi", False),
])
def test_routing_by_platform(platform, shape, method, kernel):
    grid = Grid(shape=shape, spacing=(1.0,) * len(shape))
    cfg = EikonalConfig(method=method, tol=1e-3, max_iters=10)
    assert (TRITON_CALL in _lowered(grid, cfg, platform)) == kernel


def test_custom_vmap_merges_nested_batches():
    """vmap(vmap(solve)) reaches the solver as one flat batch and equals
    the solves done one at a time."""
    grid = Grid(shape=(9, 8, 7), spacing=(1.0, 1.0, 1.0))
    cfg = EikonalConfig(tol=1e-5, max_iters=50)
    srcs = jnp.asarray([[2.0, 2.0, 2.0], [6.0, 5.0, 4.0]], jnp.float32)
    s = 1.0 + 0.2 * jax.random.uniform(jax.random.PRNGKey(1),
                                       (3, 2) + grid.shape)
    nested = jax.jit(jax.vmap(jax.vmap(
        lambda si, x: batched.solve_eikonal_batched(si, x[None], grid, cfg)[0],
        in_axes=(0, 0)), in_axes=(0, None)))(s, srcs)
    for a in range(3):
        for b in range(2):
            one = batched.solve_eikonal_batched(s[a, b], srcs[b:b + 1], grid,
                                                cfg)[0]
            np.testing.assert_array_equal(np.asarray(nested[a, b]),
                                          np.asarray(one))


def test_kernel_solve_wrapper_matches_xla_solve():
    """The two implementations behind the routing rule, called directly
    (as chip_smoke.py times them), agree on a flat batch."""
    grid = Grid(shape=(8, 10, 9), spacing=(1.0, 1.0, 1.0))
    cfg = EikonalConfig(tol=1e-5, max_iters=60)
    T0, frozen, s = _fields(grid, [[1.0, 2.0, 3.0], [6.0, 8.0, 7.0]], seed=5)
    a = batched.kernel_solve(T0, frozen, s, grid, cfg, interpret=True)
    b = batched.xla_solve(T0, frozen, s, grid, cfg)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                               rtol=0)


@pytest.mark.gpu
def test_kernel_compiled_on_card(gpu):
    """The compiled kernel (no interpreter) against the XLA sweep on the
    card, at c2's field shape."""
    grid = Grid(shape=(64, 64, 64), spacing=(1.0, 1.0, 1.0))
    with jax.default_device(gpu):
        T0, frozen, s = _fields(grid, [[8.0, 20.0, 3.0], [50.0, 40.0, 60.0]])
        cfg = EikonalConfig(tol=1e-5, max_iters=100)
        a = jax.jit(lambda *x: batched.kernel_solve(*x, grid, cfg))(
            T0, frozen, s)
        b = jax.jit(lambda *x: batched.xla_solve(*x, grid, cfg))(
            T0, frozen, s)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                               rtol=0)


def test_kernel_splits_a_sharded_batch():
    """With the flat batch sharded over a mesh (chains over cards), each
    device solves its own fields: the result stays sharded, nothing is
    gathered, and it equals the unsharded reference."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    grid = Grid(shape=(8, 9, 7), spacing=(1.0, 1.0, 1.0))
    cfg = EikonalConfig(tol=1e-5, max_iters=50)
    T0, frozen, s = _fields(grid, [[2.0, 3.0, 4.0], [5.0, 6.0, 2.0]] * 2,
                            seed=6)
    ref = batched.xla_solve(T0, frozen, s, grid, cfg)
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("chains",))
    sharding = NamedSharding(mesh, PartitionSpec("chains"))
    args = [jax.device_put(x, sharding) for x in (T0, frozen, s)]
    f = jax.jit(lambda *a: batched.kernel_solve(*a, grid, cfg,
                                                interpret=True))
    out = f(*args)
    assert out.sharding.spec == PartitionSpec("chains")
    assert "all-gather" not in f.lower(*args).compile().as_text()
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5,
                               rtol=0)
