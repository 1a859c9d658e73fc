"""Eikonal solvers: |grad T| = s on regular 2-D/3-D grids.

Replacement for the reference's serial Fortran fast-sweeping solver
(SURVEY.md §1 L0, §2.1 rows 1-4): instead of recursive Gauss-Seidel
sweeps, we use massively parallel update schemes:

- ``solve_eikonal(..., method="jacobi")`` — full-grid monotone Jacobi
  (fast-iterative) updates inside ``lax.while_loop``. Simple, and the
  one-step operator is the fixed point map used by the implicit adjoint.
- ``solve_eikonal(..., method="sweep")`` — directional plane sweeps:
  Gauss-Seidel along the swept axis (``lax.scan`` over planes), Jacobi in
  the transverse plane. Converges in a few cycles like classic FSM.
- ``sweep_kernel`` — the sweep method as one Pallas (Triton) GPU kernel
  per batched solve, one program per field; ``batched`` routes CUDA
  lowerings of 3-D sweep solves to it.
"""

from mceik_tpu.eikonal.godunov import godunov_update, neighbor_min, BIG  # noqa: F401
from mceik_tpu.eikonal.solve import solve_eikonal, seed_source, EikonalConfig  # noqa: F401
