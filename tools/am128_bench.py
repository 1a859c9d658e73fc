"""Sampler-level datapoint at the config-5 grid scale (VERDICT r4 #9):
AM chain-steps/s on a 128^3 checkerboard field.

This runs the ACTUAL sampler loop (AM, inv 12^3, 8 src, 12 rec) at 128^3
and reports chain-steps/s with the ms per field solve it implies
(step wall = n_chains x n_src solves x ms_per_solve, plus the likelihood).

Sampling runs in chunks like gradient_sampler_bench.

Usage:  python tools/am128_bench.py [--n-chains 4] [--steps 60]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import gradient_sampler_bench as gsb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--n-src", type=int, default=8)
    args = ap.parse_args()

    print(json.dumps({"device": {"platform": jax.devices()[0].platform,
                                 "kind": jax.devices()[0].device_kind,
                                 "count": len(jax.devices())},
                      "workload": f"checkerboard3d 128^3, {args.n_src} src,"
                                  f" 12 rec, inv 12^3, tol 1e-3, "
                                  f"{args.n_chains} chains"}), flush=True)
    post, _ = gsb.build(n=128, inv=12, n_src=args.n_src, n_rec=12)
    row = gsb.run_am(post, n_chains=args.n_chains, n_warmup=args.warmup,
                     n_steps=args.steps, thin=2)
    solves_per_step = args.n_chains * args.n_src
    print(json.dumps({
        "solves_per_step": solves_per_step,
        "measured_chain_steps_per_s": row["chain_steps_per_s"],
        "measured_ms_per_solve": round(
            1e3 * args.n_chains / (row["chain_steps_per_s"]
                                   * solves_per_step), 2),
    }), flush=True)


if __name__ == "__main__":
    main()
