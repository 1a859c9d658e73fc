"""Distribution layer (SURVEY.md §1 L4, §2.4): device mesh construction,
chain/particle sharding, collective helpers, distributed resampling.

The replacement for the reference's MPI layer: no user-level
transport code exists — `jax.distributed` + `Mesh` + sharding annotations
make XLA emit `psum`/`all_gather`/`ppermute` collectives (NCCL between
GPUs)."""

from mceik_tpu.dist.mesh import chain_mesh, shard_chains, replicate  # noqa: F401
