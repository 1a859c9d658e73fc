"""Device mesh + chain sharding (SURVEY.md §2.3 "DP (chain parallelism)").

Chains/particles are the embarrassingly parallel axis: every chain-batched
state leaf gets sharded over the ``chains`` mesh axis; cross-chain pooled
statistics (adaptation, moments, ESS) are plain ``jnp.mean``/``sum`` over
the chain axis, which XLA turns into all-reduces under jit. The
single-process fallback is a mesh of 1 — every workload runs unmodified on
CPU (SURVEY.md §2.4).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mceik_tpu.config import DistCfg


def init_distributed(cfg: DistCfg) -> None:
    """Multi-host initialization (config 5). No-op in single-process runs.

    ``jax.distributed.initialize()`` only succeeds under a cluster
    launcher (coordinator address and process ids in the environment);
    outside one it raises.
    Falling back to single-process keeps pod configs runnable at reduced
    scale on a dev chip — the c5 config is smoke-testable anywhere.
    """
    if cfg.multihost:
        try:
            jax.distributed.initialize()
        except Exception as e:  # no coordinator: single-process fallback
            import warnings
            warnings.warn(
                f"dist.multihost=true but jax.distributed.initialize() "
                f"failed ({e}); continuing single-process")


def chain_mesh(cfg: Optional[DistCfg] = None, n_devices: Optional[int] = None,
               axis: str = "chains") -> Mesh:
    """1-D mesh of all (or the first ``n_devices``) devices."""
    if cfg is not None:
        axis = cfg.chain_axis
        n_devices = cfg.n_devices
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_chains(tree: Any, mesh: Mesh, axis: str = "chains") -> Any:
    """Shard every leaf's leading (chain) axis over the mesh."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1))) if x.ndim >= 1 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree.map(put, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree on every device of the mesh."""
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree.map(put, tree)
