"""On-chip SMC benchmark for the config-4 workload (VERDICT r2 #6).

Runs configs/c4_smc.json's 10k-particle tempered ladder on the visible
device (single chip here; the sharded-across-chips path is proven
separately — tests/test_dist.py, dryrun D) and reports stages-to-beta=1,
wall time, particle-mutation-steps/s and logZ. The vmapped 2-D XLA sweep
solves all 10k x n_src fields per mutation step in one batch, so the
mutation stage is one large compiled execution per stage.

Usage: python tools/smc_bench.py [--config configs/c4_smc.json]
       [--n-particles N] (override for smoke tests)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "c4_smc.json"))
    ap.add_argument("--n-particles", type=int, default=None)
    args = ap.parse_args()

    from mceik_tpu.io.config_io import load_config
    from mceik_tpu.samplers.smc import run_smc_config

    cfg = load_config(args.config)
    if args.n_particles:
        # RunConfig/SamplerCfg are plain frozen dataclasses (no .replace
        # method) — use dataclasses.replace (ADVICE r3, medium).
        cfg = dataclasses.replace(cfg, sampler=dataclasses.replace(
            cfg.sampler, n_particles=args.n_particles))

    print(json.dumps({"device": {"platform": jax.devices()[0].platform,
                                 "kind": jax.devices()[0].device_kind,
                                 "count": len(jax.devices())},
                      "n_particles": cfg.sampler.n_particles,
                      "n_mutation_steps": cfg.sampler.n_mutation_steps,
                      "grid": list(cfg.grid.shape)}), flush=True)

    t0 = time.perf_counter()
    result = run_smc_config(cfg, verbose=True)
    wall = time.perf_counter() - t0

    n_mut = cfg.sampler.n_particles * cfg.sampler.n_mutation_steps \
        * result.n_stages
    print(json.dumps({
        "config": os.path.basename(args.config),
        "n_stages": result.n_stages,
        "beta_final": round(result.betas[-1], 4),
        "log_evidence": round(result.log_evidence, 2),
        "wall_s": round(wall, 1),
        "particle_mutation_steps_per_s": round(n_mut / wall, 0),
        "mean_accept": round(sum(result.accept_history)
                             / max(len(result.accept_history), 1), 3),
        "min_ess": round(min(result.ess_history), 0),
    }), flush=True)


if __name__ == "__main__":
    main()
