"""Posterior builder: priors + Gaussian traveltime likelihood as one pure
``logpost(params) -> scalar`` closure (SURVEY.md §1 L2, §3.1).

The returned closure is jit/vmap/grad-safe; samplers never see geometry or
solver details. Modes:

- ``tomo``   — slowness only, known sources (configs 1-2).
- ``joint``  — slowness + hypocenters + origin times (configs 3/5).
- ``locate`` — hypocenters only over *fixed* slowness: station traveltime
  tables are precomputed once at build time, so each likelihood eval is
  just interpolation + reduction (SURVEY.md §3.5).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from mceik_tpu.config import EikonalCfg, ModelCfg
from mceik_tpu.eikonal.solve import EikonalConfig
from mceik_tpu.forward.predict import predict_events, predict_tomo, traveltime_tables
from mceik_tpu.grid import Grid
from mceik_tpu.model.data import EventData, TomoData
from mceik_tpu.model.params import (
    Params,
    box_from_raw,
    box_logjac,
    slowness_from_u,
)


def _eik_config(cfg: EikonalCfg) -> EikonalConfig:
    return EikonalConfig(
        method=cfg.method, tol=cfg.tol, max_iters=cfg.max_iters,
        n_inner=cfg.n_inner, seed_radius=cfg.seed_radius,
    )


@dataclasses.dataclass(frozen=True)
class PosteriorModel:
    """Bundle of pure functions defining the posterior."""

    logpost: Callable[[Params], jnp.ndarray]
    init_params: Callable[..., Params]  # (key, jitter=1.0) -> Params
    slowness_of: Callable[[Params], Optional[jnp.ndarray]]
    predict: Callable[[Params], jnp.ndarray]  # t_pred for diagnostics
    grid: Grid
    cfg: ModelCfg
    n_dim: int  # total number of sampled scalars
    prior_scales: Params = None  # per-leaf natural scales for proposals
    # Split components (SMC tempering needs the likelihood alone) and exact
    # prior sampling (SMC particle initialization).
    log_prior: Callable[[Params], jnp.ndarray] = None
    log_lik: Callable[[Params], jnp.ndarray] = None
    sample_prior: Callable[[jnp.ndarray], Params] = None
    # Trans-dimensional spike-slab noise: exact systematic-scan Gibbs sweep
    # over the station indicators, (key, params, beta=1.0) ->
    # (params, log_prior, log_lik). None unless noise_model="spike_slab".
    noise_gibbs: Callable = None


def _gaussian_loglik(r, sigma, mask):
    if mask is None:
        mask = jnp.ones_like(r)
    z = r / sigma
    return -0.5 * jnp.sum(mask * z * z) - jnp.sum(mask * jnp.log(sigma))


def _marginalized_t0_loglik(r, sigma, mask):
    """Exact origin-time marginalization under a flat t0 prior.

    Integrating exp(-0.5 sum_j w_j (r_j - t0)^2) dt0 per event with
    w_j = mask_j / sigma_j^2 gives precision-weighted demeaning plus a
    -0.5 log(sum_j w_j) Gaussian-integral term. For constant sigma this
    reduces (up to a constant) to the plain per-event demeaning the r1
    code used; the weighted form stays exact for per-station /
    hierarchical / spike-slab sigma, where plain demeaning is not.
    """
    w = mask / (sigma * sigma)
    sw = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-20)
    t0_hat = jnp.sum(w * r, axis=1, keepdims=True) / sw
    quad = jnp.sum(w * (r - t0_hat) ** 2)
    return (-0.5 * quad - jnp.sum(mask * jnp.log(sigma))
            - 0.5 * jnp.sum(jnp.log(sw[:, 0])))


def build_posterior(
    cfg: ModelCfg,
    data,
    grid: Grid,
    eik_cfg: EikonalCfg = EikonalCfg(),
    differentiable: bool = False,
    fixed_slowness=None,
) -> PosteriorModel:
    """Construct the posterior for the given mode and observed data.

    ``differentiable=True`` routes slowness gradients through the implicit
    eikonal adjoint (required by HMC/NUTS; slightly more expensive).

    ``fixed_slowness`` (locate mode): the *given* heterogeneous velocity
    model traveltime tables are built over — an array, or None to use
    ``cfg.fixed_slowness_path`` / the homogeneous background. The
    reference locates events over precomputed tables of a supplied model
    (SURVEY.md §2.1 "Locate events over precomputed tables").
    """
    econf = _eik_config(eik_cfg)
    D = grid.ndim
    bg = jnp.asarray(cfg.background_slowness, dtype=jnp.float32)
    noise_model = cfg.resolved_noise_model()
    if noise_model not in ("fixed", "hierarchical", "spike_slab"):
        raise ValueError(f"unknown noise_model {noise_model!r}")

    def sigma_of(params: Params):
        sigma = jnp.asarray(cfg.sigma, dtype=jnp.float32)
        if noise_model == "hierarchical" and params.log_sigma is not None:
            sigma = sigma * jnp.exp(params.log_sigma)
        elif noise_model == "spike_slab":
            # z_j = 0 -> spike (base sigma); z_j = 1 -> slab inflation
            # exp(log_sigma_j), slab prior N(noise_slab_mu, sigma_hyper)
            # centered at genuine inflation (see config.py rationale).
            sigma = sigma * jnp.exp(params.noise_z * params.log_sigma)
        return sigma

    def log_prior(params: Params):
        lp = jnp.asarray(0.0, dtype=jnp.float32)
        if params.u is not None:
            lp += -0.5 * jnp.sum((params.u / cfg.prior_sigma_u) ** 2)
        if params.hypo_raw is not None:
            lp += box_logjac(params.hypo_raw)
        if params.t0 is not None:
            lp += -0.5 * jnp.sum((params.t0 / cfg.prior_sigma_t0) ** 2)
        if noise_model == "hierarchical" and params.log_sigma is not None:
            lp += -0.5 * jnp.sum((params.log_sigma / cfg.sigma_hyper) ** 2)
        elif noise_model == "spike_slab":
            z = params.noise_z
            lp += jnp.sum(z * np.log(cfg.noise_p0)
                          + (1.0 - z) * np.log1p(-cfg.noise_p0))
            # Slab doubles as the pseudo-prior for inactive components, so
            # one Gaussian term covers all stations and the Gibbs odds
            # reduce to (tempered) likelihood ratio x prior odds.
            lp += -0.5 * jnp.sum(
                ((params.log_sigma - cfg.noise_slab_mu) / cfg.sigma_hyper) ** 2)
        return lp

    def _init_noise(key, jitter, n_sta_axis):
        """(log_sigma, noise_z) chain-init draws for the configured model."""
        ls, z = None, None
        if noise_model == "hierarchical":
            shape = (n_sta_axis,) if cfg.per_station_noise else ()
            ls = jitter * 0.1 * jax.random.normal(key, shape, dtype=jnp.float32)
        elif noise_model == "spike_slab":
            ls = cfg.noise_slab_mu + jitter * 0.1 * cfg.sigma_hyper * \
                jax.random.normal(key, (n_sta_axis,), dtype=jnp.float32)
            # Start ALL-ACTIVE: with every station down-weighted equally
            # the slowness field converges toward truth under balanced
            # weights, then clean stations flip off one by one. Starting
            # all-clean invites an absorbing trap: a transiently misfit
            # clean station flips on, loses likelihood weight, and the
            # field then never learns to fit it (observed in testing —
            # chains pinned different clean stations at z=1 with 3-sigma
            # residuals held by their own down-weighting).
            z = jnp.ones((n_sta_axis,), jnp.float32)
        return ls, z

    if cfg.mode == "tomo":
        assert isinstance(data, TomoData)
        n_src, n_rec = data.t_obs.shape
        n_sta_axis = n_rec

        def predict(params: Params):
            s = slowness_from_u(params.u, grid, bg)
            return predict_tomo(s, data.src_xyz, data.rec_xyz, grid, econf,
                                differentiable=differentiable)

        def residuals_of(params: Params):
            mask = (data.mask if data.mask is not None
                    else jnp.ones_like(data.t_obs))
            return data.t_obs - predict(params), mask

        def lik_term(r, mask, sigma):
            return _gaussian_loglik(r, sigma, mask)

        def log_lik(params: Params):
            r, mask = residuals_of(params)
            return lik_term(r, mask, sigma_of(params))

        def init_params(key, jitter: float = 1.0):
            ks = jax.random.split(key, 2)
            u = jitter * 0.1 * cfg.prior_sigma_u * jax.random.normal(
                ks[0], cfg.inv_shape, dtype=jnp.float32)
            ls, z = _init_noise(ks[1], jitter, n_rec)
            return Params(u=u, log_sigma=ls, noise_z=z)

        slowness_of = lambda p: slowness_from_u(p.u, grid, bg)

    elif cfg.mode in ("joint", "locate"):
        assert isinstance(data, EventData)
        n_ev, n_sta = data.t_obs.shape
        n_sta_axis = n_sta

        fixed_tables = None
        if cfg.mode == "locate":
            if fixed_slowness is not None:
                s_fixed = jnp.asarray(fixed_slowness, jnp.float32)
            elif cfg.fixed_slowness_path:
                from mceik_tpu.io.loaders import load_slowness_hdf5
                s_fixed = jnp.asarray(
                    load_slowness_hdf5(cfg.fixed_slowness_path, grid),
                    jnp.float32)
            else:
                s_fixed = bg * jnp.ones(grid.shape, dtype=jnp.float32)
            if s_fixed.shape != tuple(grid.shape):
                raise ValueError(
                    f"fixed slowness shape {s_fixed.shape} != grid "
                    f"{tuple(grid.shape)}")
            if cfg.table_cache_dir:
                from mceik_tpu.forward.tables_cache import cached_traveltime_tables
                fixed_tables = jnp.asarray(cached_traveltime_tables(
                    s_fixed, data.sta_xyz, grid, econf,
                    cache_dir=cfg.table_cache_dir))
            else:
                fixed_tables = traveltime_tables(s_fixed, data.sta_xyz, grid,
                                                 econf)

        def tables_of(params: Params):
            if cfg.mode == "locate":
                return fixed_tables
            s = slowness_from_u(params.u, grid, bg)
            return traveltime_tables(s, data.sta_xyz, grid, econf,
                                     differentiable=differentiable)

        def predict(params: Params):
            hypo = box_from_raw(params.hypo_raw, grid)
            t0 = params.t0 if params.t0 is not None else jnp.zeros(
                (params.hypo_raw.shape[0],), dtype=jnp.float32)
            return predict_events(tables_of(params), hypo, t0, grid)

        def residuals_of(params: Params):
            r = data.t_obs - predict(params)
            mask = data.mask if data.mask is not None else jnp.ones_like(r)
            return r, mask

        def lik_term(r, mask, sigma):
            if cfg.marginalize_t0:
                return _marginalized_t0_loglik(r, sigma, mask)
            return _gaussian_loglik(r, sigma, mask)

        def log_lik(params: Params):
            r, mask = residuals_of(params)
            return lik_term(r, mask, sigma_of(params))

        def init_params(key, jitter: float = 1.0):
            ks = jax.random.split(key, 4)
            u = None
            if cfg.mode == "joint":
                u = jitter * 0.1 * cfg.prior_sigma_u * jax.random.normal(
                    ks[0], cfg.inv_shape, dtype=jnp.float32)
            hypo_raw = jitter * 0.5 * jax.random.normal(ks[1], (n_ev, D),
                                                        dtype=jnp.float32)
            t0 = None
            if not cfg.marginalize_t0:
                t0 = jitter * 0.1 * cfg.prior_sigma_t0 * jax.random.normal(
                    ks[2], (n_ev,), dtype=jnp.float32)
            ls, z = _init_noise(ks[3], jitter, n_sta)
            return Params(u=u, hypo_raw=hypo_raw, t0=t0, log_sigma=ls,
                          noise_z=z)

        slowness_of = (
            (lambda p: slowness_from_u(p.u, grid, bg)) if cfg.mode == "joint"
            else (lambda p: None)
        )
    else:
        raise ValueError(f"unknown model mode {cfg.mode!r}")

    def logpost(params: Params):
        return log_prior(params) + log_lik(params)

    def sample_prior(key):
        """Exact draw from the prior in the unconstrained basis.

        hypo_raw's prior is standard logistic (the pushforward of the
        uniform-in-box prior through the inverse sigmoid)."""
        ks = jax.random.split(key, 4)
        ex = init_params(jax.random.PRNGKey(0))

        def maybe(field, draw):
            return None if getattr(ex, field) is None else draw

        u = maybe("u", lambda: cfg.prior_sigma_u * jax.random.normal(
            ks[0], cfg.inv_shape, dtype=jnp.float32))
        hypo_raw = maybe("hypo_raw", lambda: jax.random.logistic(
            ks[1], ex.hypo_raw.shape, dtype=jnp.float32))
        t0 = maybe("t0", lambda: cfg.prior_sigma_t0 * jax.random.normal(
            ks[2], ex.t0.shape, dtype=jnp.float32))
        ks3a, ks3b = jax.random.split(ks[3])
        ls_mu = cfg.noise_slab_mu if noise_model == "spike_slab" else 0.0
        ls = maybe("log_sigma", lambda: ls_mu + cfg.sigma_hyper
                   * jax.random.normal(ks3a, jnp.shape(ex.log_sigma),
                                       dtype=jnp.float32))
        z = maybe("noise_z", lambda: jax.random.bernoulli(
            ks3b, cfg.noise_p0, jnp.shape(ex.noise_z)).astype(jnp.float32))
        return Params(
            u=u() if callable(u) else u,
            hypo_raw=hypo_raw() if callable(hypo_raw) else hypo_raw,
            t0=t0() if callable(t0) else t0,
            log_sigma=ls() if callable(ls) else ls,
            noise_z=z() if callable(z) else z,
        )

    # --- trans-dimensional noise: exact Gibbs over the indicators --------
    noise_gibbs = None
    if noise_model == "spike_slab":
        log_odds0 = float(np.log(cfg.noise_p0) - np.log1p(-cfg.noise_p0))
        sigma0 = jnp.asarray(cfg.sigma, jnp.float32)

        def noise_gibbs(key, params: Params, beta=1.0):
            """Systematic-scan Gibbs sweep over the station indicators plus
            a pseudo-prior refresh of the inactive slab values.

            One forward solve total: the expensive predict is evaluated
            once and its residuals reused across all 2*n_sta toggled
            likelihood evaluations (the indicators never enter the eikonal
            solve). With per-event t0 marginalization the stations couple,
            so the scan recomputes the full (cheap) reduction per toggle —
            the update stays an *exact* conditional draw either way.
            ``beta`` tempers the likelihood ratio for SMC mutation stages.
            Returns (params, log_prior, log_lik).
            """
            r, mask = residuals_of(params)
            ls = params.log_sigma

            def ll_z(z):
                return lik_term(r, mask, sigma0 * jnp.exp(z * ls))

            def body(j, carry):
                z, k = carry
                k, kj = jax.random.split(k)
                logit = log_odds0 + beta * (ll_z(z.at[j].set(1.0))
                                            - ll_z(z.at[j].set(0.0)))
                zj = jax.random.bernoulli(kj, jax.nn.sigmoid(logit))
                return z.at[j].set(zj.astype(jnp.float32)), k

            k_scan, k_fresh = jax.random.split(key)
            z, _ = lax.fori_loop(0, n_sta_axis, body,
                                 (params.noise_z, k_scan))
            # Inactive slab values have the pseudo-prior as their exact
            # full conditional (the likelihood never reads them): refresh.
            fresh = cfg.noise_slab_mu + cfg.sigma_hyper * jax.random.normal(
                k_fresh, ls.shape)
            ls_new = jnp.where(z > 0, ls, fresh)
            new = params.replace(noise_z=z, log_sigma=ls_new)
            return new, log_prior(new), lik_term(r, mask, sigma_of(new))

    example = init_params(jax.random.PRNGKey(0))
    n_dim = sum(int(x.size) for x in jax.tree.leaves(example))

    scale_of = {
        "u": cfg.prior_sigma_u,
        "hypo_raw": 1.0,
        "t0": cfg.prior_sigma_t0,
        "log_sigma": cfg.sigma_hyper,
        # Indicators are frozen for every continuous kernel (scale 0);
        # they move only through noise_gibbs.
        "noise_z": 0.0,
    }
    prior_scales = Params(**{
        f: (None if getattr(example, f) is None
            else jnp.full_like(getattr(example, f), scale_of[f]))
        for f in scale_of
    })

    return PosteriorModel(
        logpost=logpost,
        init_params=init_params,
        slowness_of=slowness_of,
        predict=predict,
        grid=grid,
        cfg=cfg,
        n_dim=n_dim,
        prior_scales=prior_scales,
        log_prior=log_prior,
        log_lik=log_lik,
        sample_prior=sample_prior,
        noise_gibbs=noise_gibbs,
    )
