"""Typed, nested run configuration (SURVEY.md §5 "Config / flag system").

Replaces the reference's text/ini + argv parsing with frozen dataclasses
loadable from JSON (io/config_io.py) and overridable with dotted
``--key=value`` CLI flags. Every workload config from SURVEY.md §0 ships as
a checked-in file under ``configs/``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from mceik_tpu.grid import Grid


@dataclasses.dataclass(frozen=True)
class GridCfg:
    shape: Tuple[int, ...] = (65, 65)
    spacing: Tuple[float, ...] = (1.0, 1.0)
    origin: Tuple[float, ...] = None  # type: ignore[assignment]

    def build(self) -> Grid:
        return Grid(shape=self.shape, spacing=self.spacing, origin=self.origin)


@dataclasses.dataclass(frozen=True)
class EikonalCfg:
    method: str = "sweep"
    tol: float = 1e-4
    max_iters: int = 50
    n_inner: int = 2
    seed_radius: float = 3.0


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    """Probabilistic model (SURVEY.md §1 L2).

    mode:
      "tomo"  — slowness field only, known sources (configs 1-2).
      "joint" — slowness + event hypocenters/origin times (config 3/5).
      "locate"— hypocenters only, fixed slowness (locate mode, §3.5).
    """

    mode: str = "tomo"
    # Coarse inversion grid for the log-slowness deviation field u; the
    # forward solver runs on the (finer) GridCfg grid. s = s_bg * exp(up(u)).
    inv_shape: Tuple[int, ...] = (16, 16)
    background_slowness: float = 1.0
    prior_sigma_u: float = 0.5
    # Observation-noise model (config 5 "trans-dimensional noise
    # hyperparameters"):
    #   "fixed"        — sigma constant.
    #   "hierarchical" — continuous relaxation: log_sigma sampled with a
    #                    N(0, sigma_hyper^2) hyperprior (scalar or
    #                    per-station via per_station_noise).
    #   "spike_slab"   — genuinely trans-dimensional per-station noise:
    #                    indicator z_j ~ Bernoulli(noise_p0) switches
    #                    station j between the base sigma (spike) and an
    #                    inflated sigma * exp(log_sigma_j) with log_sigma_j
    #                    ~ N(noise_slab_mu, sigma_hyper^2) (slab; the
    #                    location keeps "active" meaning a *qualitatively*
    #                    noisy station — a zero-mode slab would absorb
    #                    ordinary chi^2 fluctuation of clean stations'
    #                    sample RMS). Indicators move by exact
    #                    systematic-scan Gibbs between continuous steps
    #                    (model/posterior.py noise_gibbs); the
    #                    active-component count is the sampled dimension.
    # hierarchical_noise=True is honored as noise_model="hierarchical" for
    # backward compatibility.
    sigma: float = 0.01
    noise_model: Optional[str] = None
    hierarchical_noise: bool = False
    sigma_hyper: float = 1.0
    per_station_noise: bool = False
    noise_p0: float = 0.1
    noise_slab_mu: float = 2.0  # slab center: e^2 ~ 7.4x inflation

    def resolved_noise_model(self) -> str:
        if self.noise_model is not None:
            return self.noise_model
        return "hierarchical" if self.hierarchical_noise else "fixed"
    # Event priors (joint/locate modes).
    prior_sigma_t0: float = 1.0
    # Analytic origin-time handling: demean residuals per event (exact
    # marginalization under improper flat t0 prior).
    marginalize_t0: bool = False
    # Locate mode over a *given* heterogeneous velocity model: HDF5 file
    # (io/loaders.py save_slowness_hdf5) holding the fixed slowness field;
    # None keeps the homogeneous background. table_cache_dir additionally
    # caches the per-station traveltime tables on disk
    # (forward/tables_cache.py) for reuse across event batches.
    fixed_slowness_path: Optional[str] = None
    table_cache_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SamplerCfg:
    algorithm: str = "rwm"  # rwm | am | am_full | pcn | hmc | nuts | mala | smc
    n_chains: int = 4
    n_warmup: int = 500
    n_samples: int = 1000
    thin: int = 1
    seed: int = 0
    target_accept: float = 0.234
    # Initial proposal scales (adapted during warmup).
    step_size: float = 0.02
    # HMC/NUTS.
    n_leapfrog: int = 16
    max_tree_depth: int = 6
    # SMC.
    n_particles: int = 1024
    ess_threshold: float = 0.5
    n_mutation_steps: int = 5
    # pCN proposal for field parameters under Gaussian prior (RWM/AM only).
    use_pcn: bool = False
    # Preconditioning mode.
    # mala: "laplace" computes the MAP + Gauss-Newton covariance once at
    #   startup (model/laplace.py) and pins it as the proposal
    #   preconditioner + chain-init distribution; "none" adapts a full
    #   Haario covariance from chain history instead.
    # hmc/nuts/pcn: "whitened" runs the sampler in the Laplace-whitened
    #   coordinates x = x_map + L u (model/whitened.py) — dense GN mass
    #   for hmc/nuts, generalized (Laplace-referenced) pCN for pcn.
    #   Their default behavior ignores the "laplace" value (kept as the
    #   config default for the mala path).
    precondition: str = "laplace"
    n_map_steps: int = 150


@dataclasses.dataclass(frozen=True)
class DataCfg:
    # Synthetic generators: crosswell2d | checkerboard3d | events3d.
    # Observed data: "file" (HDF5 written by io/loaders.py, station/arrival
    # tables + optional truth model) or "csv" (stations_path + arrivals_path
    # station/arrival tables; missing picks -> masked residuals).
    dataset: str = "crosswell2d"
    path: Optional[str] = None
    stations_path: Optional[str] = None
    arrivals_path: Optional[str] = None
    n_src: int = 8
    n_rec: int = 12
    n_events: int = 0
    n_stations: int = 0
    noise: float = 0.01
    seed: int = 1234
    # Checkerboard truth used to generate synthetic arrivals.
    checker_cells: Tuple[int, ...] = (4, 4)
    checker_amplitude: float = 0.15


@dataclasses.dataclass(frozen=True)
class DistCfg:
    # Name of the mesh axis chains/particles shard over; mesh covers all
    # visible devices unless n_devices caps it.
    chain_axis: str = "chains"
    n_devices: Optional[int] = None
    # Multi-host: call jax.distributed.initialize() before building mesh.
    multihost: bool = False


@dataclasses.dataclass(frozen=True)
class IOCfg:
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # steps; 0 disables
    resume: Optional[str] = None
    log_every: int = 100
    # Dump one jax.profiler trace (xprof/tensorboard-viewable) of the
    # first post-compile sampling segment into this directory.
    profile_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RunConfig:
    grid: GridCfg = GridCfg()
    eikonal: EikonalCfg = EikonalCfg()
    model: ModelCfg = ModelCfg()
    sampler: SamplerCfg = SamplerCfg()
    data: DataCfg = DataCfg()
    dist: DistCfg = DistCfg()
    io: IOCfg = IOCfg()
