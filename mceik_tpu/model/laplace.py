"""Laplace / Gauss-Newton posterior approximation: MAP estimate and the
exact Gauss-Newton covariance, used as a PRECONDITIONER for the
full-covariance samplers (VERDICT r2 next-step #2).

Why this exists: the tomography posterior over the inversion basis u is
near-Gaussian (Gaussian prior + mildly nonlinear forward), with covariance

    C = (P + J^T W J)^{-1},   J = d t_pred / d x  (n_obs x d),
                              P = prior precision, W = noise precision,

whose soft directions (data null space) are exactly what diagonal
proposals/masses cannot see — measured per-cell autocorrelation times in
the thousands for diag-AM/HMC/NUTS at d = 1728 (BASELINE.md 2026-08-19
r2). Learning C from chain history needs far more mixed samples than the
chain produces (chicken-and-egg); computing it COSTS ONLY n_obs adjoint
VJPs (~100 gradients, a one-time setup ~ seconds on chip) and gives the
near-ideal preconditioner for mala/am_full in one shot.

Structure: J rows come from ``lax.map`` over one-hot cotangents of
a single ``jax.vjp`` — the forward eikonal solves happen once, each row
re-runs only the (cheap) adjoint transport, memory stays O(1 row), and
the whole thing is one compiled executable. The d x d assembly and inverse
are single matmuls/factorizations (d ~ 2k).

Exactness note: the returned covariance is a PROPOSAL tuning only — MH
acceptance keeps every sampler exact regardless of its quality. For
``marginalize_t0`` event likelihoods the per-event precision-weighted
demeaning is applied to J (the exact GN curvature of the marginalized
likelihood); for hierarchical/spike-slab noise the base sigma is used
(documented approximation, fine for a preconditioner).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.samplers.am_full import _ravel, _unravel_fn

# float32 products: a TF32 default on the GPU would keep ~3 digits.
HIGHEST = lax.Precision.HIGHEST


def map_estimate(post, init_params=None, n_steps: int = 150,
                 lr: float = 0.02, chunk: int = 25):
    """Adam ascent on logpost from the prior mean (or ``init_params``).

    The posterior must be built with ``differentiable=True``. Frozen
    coordinates (prior scale 0) take zero gradient steps. Device work runs
    as ``chunk``-step scans, one logpost readback per chunk.
    Returns (params_map, logpost_trace list).
    """
    x0 = post.init_params(jax.random.PRNGKey(0), jitter=0.0) \
        if init_params is None else init_params
    unravel = _unravel_fn(x0)
    x = _ravel(x0)
    active = (_ravel(post.prior_scales) > 0).astype(jnp.float32)
    vg = jax.value_and_grad(lambda xf: post.logpost(unravel(xf)))

    @jax.jit
    def run_chunk(x, m, v, t0):
        def step(carry, i):
            x, m, v = carry
            val, g = vg(x)
            g = -g * active
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            t = (t0 + i + 1).astype(jnp.float32)
            mh = m / (1.0 - 0.9 ** t)
            vh = v / (1.0 - 0.999 ** t)
            x = x - lr * mh / (jnp.sqrt(vh) + 1e-8)
            return (x, m, v), val

        (x, m, v), vals = lax.scan(step, (x, m, v), jnp.arange(chunk))
        return x, m, v, vals

    m = jnp.zeros_like(x)
    v = jnp.zeros_like(x)
    trace = []
    done = 0
    while done < n_steps:
        x, m, v, vals = run_chunk(x, m, v, jnp.asarray(done, jnp.int32))
        trace.extend([float(t) for t in vals])
        done += chunk
    return unravel(x), trace


def gauss_newton_covariance(post, params, sigma: Optional[float] = None,
                            mask=None) -> jnp.ndarray:
    """Exact Gauss-Newton posterior covariance at ``params`` (full
    flattened dimension d, frozen coords as unit diagonal / zero cross
    terms — the convention am_full/mala's Cholesky constructions expect).

    sigma: observation noise std (scalar or t_obs-shaped); defaults to
    the model's base ``cfg.sigma``. mask: optional t_obs-shaped 0/1.
    """
    return covariance_from_terms(
        *gauss_newton_terms(post, params, sigma=sigma, mask=mask))


def gauss_newton_terms(post, params, sigma: Optional[float] = None,
                       mask=None):
    """The pieces of the GN Hessian ``diag(prior_prec) + J^T diag(w) J``:
    returns ``(J, w, prior_prec, active)`` with ``J`` (n_obs, d)."""
    unravel = _unravel_fn(params)
    x = _ravel(params)
    scales = _ravel(post.prior_scales)
    active = scales > 0
    d = x.shape[0]

    def predict_flat(xf):
        return post.predict(unravel(xf))

    t_pred, pullback = jax.vjp(predict_flat, x)
    obs_shape = t_pred.shape
    n_obs = int(jnp.size(t_pred))

    def row(ct_flat):
        (g,) = pullback(ct_flat.reshape(obs_shape))
        return jnp.where(active, g, 0.0)

    J = lax.map(row, jnp.eye(n_obs, dtype=t_pred.dtype))   # (n_obs, d)

    if sigma is None:
        sigma = post.cfg.sigma
    w = jnp.broadcast_to(jnp.asarray(1.0, jnp.float32) /
                         (jnp.asarray(sigma, jnp.float32) ** 2),
                         obs_shape).reshape(n_obs)
    if mask is not None:
        w = w * jnp.asarray(mask, jnp.float32).reshape(n_obs)

    if getattr(post.cfg, "marginalize_t0", False) and post.cfg.mode != "tomo":
        # Exact GN curvature of the t0-marginalized likelihood: per-event
        # precision-weighted demeaning of the J rows (the rank-1 deflation
        # J_e -> J_e - 1 (w^T J_e)/sum(w) per event block).
        n_ev, n_sta = obs_shape
        Je = J.reshape(n_ev, n_sta, d)
        we = w.reshape(n_ev, n_sta)
        sw = jnp.maximum(we.sum(axis=1, keepdims=True), 1e-20)
        wJ = jnp.einsum("es,esd->ed", we, Je, precision=HIGHEST) / sw
        Je = Je - wJ[:, None, :]
        J = Je.reshape(n_obs, d)

    prior_prec = jnp.where(active, 1.0 / jnp.maximum(scales, 1e-20) ** 2, 1.0)
    return J, w, prior_prec, active


def covariance_from_terms(J, w, prior_prec, active) -> jnp.ndarray:
    """``inv(diag(prior_prec) + J^T diag(w) J)`` with frozen coordinates
    (``active`` false) set to unit diagonal / zero cross terms."""
    H = jnp.diag(prior_prec) + jnp.matmul(J.T * w[None, :], J,
                                         precision=HIGHEST)
    C = jnp.linalg.inv(H)
    act = active.astype(C.dtype)
    return C * act[:, None] * act[None, :] + jnp.diag(1.0 - act)


def newton_refine(post, params, cov, n_steps: int = 12,
                  max_halvings: int = 8):
    """Damped Gauss-Newton refinement: x <- x + alpha C grad(x), halving
    alpha until logpost improves (C is the GN inverse-Hessian, so full
    steps converge quadratically near the optimum). At flagship scale
    (d ~ 2k) per-coordinate Adam stalls far from the optimum — measured
    logpost -2000 after 150 Adam steps on the 64^3/inv-12^3 workload where
    the refined MAP reaches the +hundreds the data supports — while one
    Newton step costs a single gradient + a d^2 matvec.

    The halving line search runs DEVICE-SIDE in one jitted call per
    Newton step (lax.while_loop) instead of a host-side loop with two
    host round trips per halving. One step costs <= max_halvings
    gradients in a single execution and one scalar readback.

    Returns (params, logpost_trace)."""
    unravel = _unravel_fn(params)
    x = _ravel(params)
    active = (_ravel(post.prior_scales) > 0).astype(jnp.float32)
    vg = jax.value_and_grad(lambda xf: post.logpost(unravel(xf)))
    cov = jnp.asarray(cov, jnp.float32)

    @jax.jit
    def newton_step(x, lp, g):
        """One damped step: returns (improved, alpha, lp_new, g_new)
        with alpha the accepted step scale (halved device-side)."""
        direction = jnp.matmul(cov, g * active, precision=HIGHEST)

        def cond(c):
            k, _, ok, _, _ = c
            return jnp.logical_and(~ok, k < max_halvings)

        def body(c):
            k, alpha, _, _, _ = c
            lp_try, g_try = vg(x + alpha * direction)
            ok = lp_try > lp
            alpha_next = jnp.where(ok, alpha, alpha * 0.5)
            return k + 1, alpha_next, ok, lp_try, g_try

        _, alpha, ok, lp_n, g_n = lax.while_loop(
            cond, body,
            (jnp.asarray(0, jnp.int32), jnp.asarray(1.0, jnp.float32),
             jnp.asarray(False), lp, g))
        # On success the loop exits without halving the accepted alpha
        # (alpha_next == alpha when ok); lp_n/g_n are at x + alpha*dir.
        return ok, alpha, lp_n, g_n, x + alpha * direction

    lp, g = jax.jit(vg)(x)
    trace = [float(lp)]
    for _ in range(n_steps):
        ok, _, lp_new, g_new, x_new = newton_step(x, lp, g)
        if not bool(ok):
            break  # no improving step along this direction — converged
        x, lp, g = x_new, lp_new, g_new
        trace.append(float(lp))
        if len(trace) >= 2 and trace[-1] - trace[-2] < 0.01:
            break
    return unravel(x), trace


def laplace_preconditioner(post, n_map_steps: int = 150, lr: float = 0.02,
                           init_params=None, n_newton: int = 12):
    """Convenience: Adam MAP ascent -> GN covariance -> damped-Newton
    refinement -> recompute the covariance at the refined MAP. Returns
    (params_map, cov, logpost_trace)."""
    p_map, trace = map_estimate(post, init_params=init_params,
                                n_steps=n_map_steps, lr=lr)
    cov = gauss_newton_covariance(post, p_map)
    if n_newton > 0:
        p_map, ntrace = newton_refine(post, p_map, cov, n_steps=n_newton)
        trace = trace + ntrace
        cov = gauss_newton_covariance(post, p_map)
    return p_map, cov, trace
