"""mceik-tpu: Bayesian traveltime tomography in JAX.

A brand-new probabilistic inference engine with the capabilities of the
reference mceik stack (Bayesian eikonal traveltime tomography: slowness
fields + earthquake hypocenters), re-designed for accelerators:

- ``eikonal``   — differentiable 3-D/2-D eikonal solvers (parallel
  fast-sweeping / fast-iterative; a Pallas GPU kernel for the hot path).
- ``forward``   — traveltime prediction: batched solves + receiver gather.
- ``model``     — priors, Gaussian residual likelihood, posterior pytrees.
- ``samplers``  — RW-Metropolis, adaptive Metropolis, HMC, NUTS, tempered SMC
  as pure transition kernels composed with ``lax.scan`` x ``vmap``.
- ``dist``      — device mesh, chain/particle sharding, collectives.
- ``io``        — configs, checkpoints (HDF5), datasets on disk.
- ``diag``      — online posterior moments, R-hat/ESS, throughput meters.
- ``datasets``  — synthetic checkerboard / crosswell generators.

Layering follows SURVEY.md §1 (right column); the reference architecture is
documented there (reference mount was empty — SURVEY.md §0 is the spec).
"""

__version__ = "0.1.0"

from mceik_tpu.grid import Grid  # noqa: F401
