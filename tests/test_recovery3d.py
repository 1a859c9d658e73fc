"""3-D checkerboard recovery integration test (SURVEY.md §4 "Integration";
VERDICT r1 #6): the MAP estimate through the DIFFERENTIABLE forward model
(implicit-adjoint gradients, eikonal/adjoint.py) must recover the 2x2x2
checkerboard from volume-acquisition arrivals.

MAP-by-gradient rather than posterior-mean-by-MCMC: deterministic, runs in
seconds, and exercises the full gradient stack end-to-end (solver ->
interp -> likelihood -> adjoint transport -> basis upsampling) — a biased
adjoint or a broken upwind weight shows up directly as failed recovery.
The posterior-MOMENT criteria live in test_golden.py / test_statistical.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
from mceik_tpu.datasets import make_dataset
from mceik_tpu.grid import Grid
from mceik_tpu.model.params import Params, slowness_from_u
from mceik_tpu.model.posterior import build_posterior


pytestmark = pytest.mark.slow

GRID = Grid(shape=(14, 14, 14), spacing=(1.0, 1.0, 1.0))
MCFG = ModelCfg(mode="tomo", inv_shape=(5, 5, 5), prior_sigma_u=0.15,
                sigma=0.01)
DCFG = DataCfg(dataset="checkerboard3d_volume", n_src=8, n_rec=10,
               noise=0.01, seed=21, checker_cells=(2, 2, 2),
               checker_amplitude=0.08)
ECFG = EikonalCfg(method="sweep", tol=1e-4, max_iters=40)


def test_map_recovers_3d_checkerboard():
    data, truth = make_dataset(GRID, DCFG, MCFG)
    post = build_posterior(MCFG, data, GRID, ECFG, differentiable=True)

    loss = lambda u: -post.logpost(Params(u=u))
    vg = jax.jit(jax.value_and_grad(loss))

    u = jnp.zeros(MCFG.inv_shape, jnp.float32)
    # Adam
    m = jnp.zeros_like(u)
    v = jnp.zeros_like(u)
    lr, b1, b2 = 0.02, 0.9, 0.999
    losses = []
    for t in range(1, 121):
        val, g = vg(u)
        losses.append(float(val))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        u = u - lr * mh / (jnp.sqrt(vh) + 1e-8)

    assert losses[-1] < losses[0] - 10.0, (losses[0], losses[-1])

    s_map = np.asarray(slowness_from_u(u, GRID, MCFG.background_slowness))
    s_true = np.asarray(truth["slowness"])
    a = s_map - s_map.mean()
    b = s_true - s_true.mean()
    corr = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert corr > 0.6, f"3-D MAP recovery_corr={corr:.3f}"
