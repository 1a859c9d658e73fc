"""Cross-device traffic audit (VERDICT r2 #8; BASELINE.json north-star
">= 0.8 multi-host scaling efficiency").

Compiles ONE sharded AM step, ONE sharded NUTS step and the two sharded
SMC stage functions on the 8-virtual-device CPU mesh and inventories every
collective in the optimized HLO with its payload size. This is the
affirmative scaling evidence a single-chip environment can produce: the
design claim (SURVEY.md §3.3 "only scalars cross hosts per step") becomes
a measured byte count, and the DCN feasibility of the >= 0.8 target is a
back-of-envelope from these numbers instead of an assertion.

    python tools/traffic_audit.py            # prints one JSON per program

DCN model: a pod-slice host link is O(100) GB/s aggregate; an MCMC step
whose collectives move B bytes adds ~B/BW + latency (~10s of us) per
step. With per-step traffic of O(100) bytes (scalars) the comm term is
sub-1% of a >= 10 ms step — the >= 0.8 target holds with wide margin as
long as no per-cell field crosses the mesh, which is exactly what this
audit asserts.
"""

import json
import os
import re
import sys

sys.path.insert(0, ".")

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

COLLECTIVES = ("all-reduce", "all-gather", "all-to-all",
               "collective-permute", "reduce-scatter",
               "collective-broadcast")
_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "u64": 8,
                "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
                "pred": 1}


def _shape_bytes(shape_str: str) -> int:
    """Sum payload bytes over every typed array in an HLO shape string
    (handles tuple shapes)."""
    total = 0
    for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_inventory(compiled) -> dict:
    """Parse the optimized HLO for collectives -> {op: {count, bytes}}."""
    txt = compiled.as_text()
    inv = {}
    for line in txt.splitlines():
        m = re.search(r"=\s+(\([^)]*\)|\S+)\s+(" + "|".join(COLLECTIVES)
                      + r")\(", line)
        if not m:
            continue
        shape, op = m.group(1), m.group(2)
        # all-reduce-start/-done pairs: count the start only.
        if "-done" in line.split("=")[0]:
            continue
        d = inv.setdefault(op, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += _shape_bytes(shape)
    return inv


def report(name, compiled, step_bytes_note=""):
    inv = collective_inventory(compiled)
    total = sum(v["bytes"] for v in inv.values())
    print(json.dumps({"program": name, "collectives": inv,
                      "total_collective_bytes": total,
                      "note": step_bytes_note}), flush=True)
    return total


def build_small(differentiable=False, n=16, inv=4, n_src=3, n_rec=4):
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.posterior import build_posterior

    grid = Grid(shape=(n, n, n), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(inv, inv, inv),
                    prior_sigma_u=0.2, sigma=0.02)
    dcfg = DataCfg(dataset="checkerboard3d", n_src=n_src, n_rec=n_rec,
                   noise=0.02, checker_cells=(2, 2, 2),
                   checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-3, max_iters=20)
    data, _ = make_dataset(grid, dcfg, mcfg)
    return build_posterior(mcfg, data, grid, ecfg,
                           differentiable=differentiable)


def audit_mcmc_step(name, post, make_kernel_hyper, n_chains=16):
    """Compile one warmup step (kernel + pooled adapt) with chains
    sharded, and inventory its collectives."""
    from mceik_tpu.dist.mesh import chain_mesh, shard_chains
    from mceik_tpu.samplers.base import _one_step, init_chain_states

    kernel, adapter, hyper, init_states = make_kernel_hyper(post)
    if init_states is None:
        states = init_chain_states(post.logpost, post.init_params,
                                   jax.random.PRNGKey(0), n_chains)
    else:
        states = init_states(jax.random.PRNGKey(0), n_chains)
    mesh = chain_mesh(n_devices=8)
    states = shard_chains(states, mesh)

    def step(states, hyper, key):
        states, _, pooled = _one_step(kernel, states, hyper, key)
        hyper = adapter(hyper, pooled, states,
                        jnp.asarray(3, jnp.int32))
        return states, hyper

    compiled = jax.jit(step).lower(states, hyper,
                                   jax.random.PRNGKey(1)).compile()
    return report(name, compiled)


def main():
    from mceik_tpu.samplers import am, hmc, nuts

    assert len(jax.devices()) == 8, jax.devices()

    def am_setup(post):
        ex = post.init_params(jax.random.PRNGKey(1))
        return (am.make_kernel(post.logpost), am.make_adapter(),
                am.init_hyper(post.prior_scales, 0.05, ex), None)

    def nuts_setup(post):
        ex = post.init_params(jax.random.PRNGKey(1))
        return (nuts.make_kernel(post.logpost, max_tree_depth=3),
                hmc.make_adapter(0.8),
                hmc.init_hyper(post.prior_scales, 0.01, ex), None)

    post = build_small(differentiable=False)
    audit_mcmc_step("am_step_16chains_8dev", post, am_setup)

    post_g = build_small(differentiable=True)
    audit_mcmc_step("nuts_step_16chains_8dev", post_g, nuts_setup)

    # SMC: the two sharded stage functions (weights/resample + mutation).
    from mceik_tpu.dist.mesh import chain_mesh, shard_chains
    from mceik_tpu.samplers.smc import (_reweight_resample_impl, _mutate_impl,
                                        _state_shardings, init_particles)
    from functools import partial

    n_particles = 256
    state = init_particles(post, jax.random.PRNGKey(2), n_particles, 0.1)
    mesh = chain_mesh(n_devices=8)
    state = shard_chains(state, mesh)
    sh = _state_shardings(state, mesh, "chains")
    from jax.sharding import NamedSharding, PartitionSpec
    scalar = NamedSharding(mesh, PartitionSpec())

    rw = jax.jit(_reweight_resample_impl, out_shardings=(sh, scalar))
    c = rw.lower(state, 0.1, 0.3, jax.random.PRNGKey(3)).compile()
    report(f"smc_reweight_resample_{n_particles}p_8dev", c,
           "includes the resample gather: O(n_particles) indices/weights")

    mut = jax.jit(partial(_mutate_impl, log_prior_fn=post.log_prior,
                          log_lik_fn=post.log_lik, n_steps=2,
                          gibbs_fn=None), out_shardings=(sh, scalar))
    c = mut.lower(state, 0.3, jax.random.PRNGKey(4),
                  post.prior_scales).compile()
    report(f"smc_mutate2_{n_particles}p_8dev", c,
           "pooled acceptance only: scalars")


if __name__ == "__main__":
    main()
