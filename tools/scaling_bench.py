"""Chain-parallel scaling-efficiency harness (BASELINE.json north-star:
>= 0.8 samples/s efficiency from 1 chip to N>=2 hosts).

Runs sharded workloads over 1, 2, ..., all visible devices and reports
throughput + efficiency vs linear scaling:

  - ``am``:   config-2-shaped diag-AM chains (the cheapest kernel)
  - ``nuts``: gradient chains (pooled dual-averaging + mass welford — the
              collective-heavier MCMC path)
  - ``smc``:  one reweight+resample+mutate stage over a sharded
              population (the only path whose collectives are
              O(n_particles), see tools/traffic_audit.py)

On a multi-host pod slice run it under the cluster launcher; on CPU pass
``--virtual 8`` to exercise the code path on virtual devices (NOTE:
virtual devices share the host's physical cores, so these efficiencies
are lower bounds, not hardware claims — SCALING_r02.json).

    python tools/scaling_bench.py --virtual 8 [--samplers am,nuts,smc]
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def parse_args():
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=24)
    p.add_argument("--chains-per-dev", type=int, default=4)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--samplers", default="am,nuts,smc")
    p.add_argument("--particles-per-dev", type=int, default=64)
    p.add_argument("--virtual", type=int, default=0,
                   help="force CPU with N virtual devices (must be set "
                        "BEFORE jax initializes — this script handles it)")
    return p.parse_args()


ARGS = parse_args()
if ARGS.virtual:
    import os
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={ARGS.virtual}").strip()

import jax  # noqa: E402

if ARGS.virtual:
    # Virtual devices exist only on the CPU backend.
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def build(n, inv=8, differentiable=False):
    from mceik_tpu.config import DataCfg, EikonalCfg, ModelCfg
    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.grid import Grid
    from mceik_tpu.model.posterior import build_posterior

    grid = Grid(shape=(n, n, n), spacing=(1.0, 1.0, 1.0))
    mcfg = ModelCfg(mode="tomo", inv_shape=(inv, inv, inv),
                    prior_sigma_u=0.2, sigma=0.01)
    dcfg = DataCfg(dataset="checkerboard3d", n_src=4, n_rec=6, noise=0.01,
                   checker_cells=(2, 2, 2), checker_amplitude=0.1)
    ecfg = EikonalCfg(method="sweep", tol=1e-3, max_iters=20)
    data, _ = make_dataset(grid, dcfg, mcfg)
    return build_posterior(mcfg, data, grid, ecfg,
                           differentiable=differentiable)


def measure_mcmc(post, which, n_devices, chains_per_dev, steps):
    from mceik_tpu.dist.mesh import chain_mesh, shard_chains
    from mceik_tpu.samplers import am, hmc, nuts
    from mceik_tpu.samplers.base import init_chain_states, run_mcmc

    n_chains = chains_per_dev * n_devices
    states = init_chain_states(post.logpost, post.init_params,
                               jax.random.PRNGKey(0), n_chains)
    mesh = chain_mesh(n_devices=n_devices)
    if n_devices > 1:
        states = shard_chains(states, mesh)
    ex = post.init_params(jax.random.PRNGKey(1))
    if which == "am":
        hyper = am.init_hyper(post.prior_scales, 0.05, ex)
        kernel = am.make_kernel(post.logpost)
    else:
        hyper = hmc.init_hyper(post.prior_scales, 0.005, ex)
        kernel = nuts.make_kernel(post.logpost, max_tree_depth=3)

    r = run_mcmc(kernel, None, states, hyper, jax.random.PRNGKey(2),
                 n_warmup=0, n_steps=3)  # compile + warm
    jax.block_until_ready(r.logpost_trace)
    t0 = time.perf_counter()
    r = run_mcmc(kernel, None, r.states, hyper, jax.random.PRNGKey(3),
                 n_warmup=0, n_steps=steps)
    jax.block_until_ready(r.logpost_trace)
    dt = time.perf_counter() - t0
    return n_chains * steps / dt


def measure_smc_stage(post, n_devices, particles_per_dev, n_mut=3,
                      reps=3):
    """One reweight+resample + mutation stage on a sharded population;
    returns particle-mutation-steps/s."""
    from functools import partial

    from mceik_tpu.dist.mesh import chain_mesh, shard_chains
    from mceik_tpu.samplers.smc import (_mutate_impl, _reweight_resample_impl,
                                        _state_shardings, init_particles)
    from jax.sharding import NamedSharding, PartitionSpec

    n_particles = particles_per_dev * n_devices
    state = init_particles(post, jax.random.PRNGKey(2), n_particles, 0.1)
    if n_devices > 1:
        mesh = chain_mesh(n_devices=n_devices)
        state = shard_chains(state, mesh)
        sh = _state_shardings(state, mesh, "chains")
        scalar = NamedSharding(mesh, PartitionSpec())
        rw = jax.jit(_reweight_resample_impl, out_shardings=(sh, scalar))
        mut = jax.jit(partial(_mutate_impl, log_prior_fn=post.log_prior,
                              log_lik_fn=post.log_lik, n_steps=n_mut,
                              gibbs_fn=None), out_shardings=(sh, scalar))
    else:
        rw = jax.jit(_reweight_resample_impl)
        mut = jax.jit(partial(_mutate_impl, log_prior_fn=post.log_prior,
                              log_lik_fn=post.log_lik, n_steps=n_mut,
                              gibbs_fn=None))

    def stage(state, key):
        k1, k2 = jax.random.split(key)
        state, _ = rw(state, 0.1, 0.3, k1)
        state, _ = mut(state, 0.3, k2, post.prior_scales)
        return state

    state = stage(state, jax.random.PRNGKey(5))     # compile + warm
    jax.block_until_ready(state.log_lik)
    t0 = time.perf_counter()
    for i in range(reps):
        state = stage(state, jax.random.PRNGKey(6 + i))
    jax.block_until_ready(state.log_lik)
    dt = time.perf_counter() - t0

    # Per-phase split (VERDICT r4 #5: attribute SMC's flat virtual-mesh
    # scaling): time reweight+resample and mutation SEPARATELY, each
    # blocked, so the O(n_particles) resample gather can be told apart
    # from the mutation sweep and from per-call host sync.
    k1, k2 = jax.random.split(jax.random.PRNGKey(50))
    t0 = time.perf_counter()
    for i in range(reps):
        s2, _ = rw(state, 0.1, 0.3, jax.random.fold_in(k1, i))
        jax.block_until_ready(s2.log_lik)
    rw_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for i in range(reps):
        s3, _ = mut(state, 0.3, jax.random.fold_in(k2, i),
                    post.prior_scales)
        jax.block_until_ready(s3.log_lik)
    mut_s = (time.perf_counter() - t0) / reps
    split = {"reweight_resample_s": round(rw_s, 4),
             "mutate_s": round(mut_s, 4),
             "stage_s": round(dt / reps, 4),
             "sync_overhead_s": round(dt / reps - rw_s - mut_s, 4)}
    return reps * n_particles * n_mut / dt, split


def main():
    devs = len(jax.devices())
    sizes = sorted({1, 2, devs // 2, devs} - {0})
    sizes = [s for s in sizes if s <= devs]
    names = ARGS.samplers.split(",")

    for which in names:
        results = {}
        for nd in sizes:
            split = None
            if which == "smc":
                post = build(ARGS.grid, differentiable=False)
                rate, split = measure_smc_stage(post, nd,
                                                ARGS.particles_per_dev)
                unit = "particle_mutation_steps_per_s"
            else:
                post = build(ARGS.grid, differentiable=(which == "nuts"))
                rate = measure_mcmc(post, which, nd, ARGS.chains_per_dev,
                                    ARGS.steps if which == "am"
                                    else max(ARGS.steps // 6, 4))
                unit = "chain_steps_per_s"
            eff = rate / (results[1] * nd) if 1 in results else 1.0
            results[nd] = rate
            row = {"sampler": which, "n_devices": nd,
                   unit: round(rate, 2),
                   "efficiency_vs_1dev": round(eff, 3)}
            if split:
                row["phase_split"] = split
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
