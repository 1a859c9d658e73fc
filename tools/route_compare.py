"""End-to-end c2 throughput with each solver implementation, on one GPU.

    python tools/route_compare.py [--turns xla,kernel,kernel,xla]

Runs the c2 deployment (64^3, 8 chains x 8 sources, AM) through
``api.run`` once per turn, in one process, with the batched solve forced
to the GPU sweep kernel or to the plain XLA sweep, and prints the
steady-state chain-steps/s of each turn: sampling segments after the first
two (which compile) divided by their wall time. Turns alternate so that
clock and thermal drift shows up as a difference between equal turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def forced_route(route: str):
    """Make every batched solve take ``route`` ("kernel" or "xla")."""
    import jax

    from mceik_tpu.eikonal import batched

    fn = {"kernel": batched.kernel_solve, "xla": batched.xla_solve}[route]
    batched._solve_flat = lambda T0, frozen, s, grid, config: fn(
        T0, frozen, s, grid, config)
    batched._core_solver.cache_clear()
    jax.clear_caches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", default="xla,kernel,kernel,xla")
    ap.add_argument("--segments", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    from mceik_tpu.api import run
    from mceik_tpu.cli import enable_compile_cache
    from mceik_tpu.io.config_io import apply_overrides, load_config

    if jax.devices()[0].platform != "gpu":
        print("route_compare: no GPU", file=sys.stderr)
        return 1
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    seg = 20
    cfg = apply_overrides(
        load_config(os.path.join(REPO, "configs", "c2_checkerboard3d.json")),
        ["sampler.n_warmup=20", f"sampler.n_samples={seg * args.segments}",
         "sampler.thin=4", f"io.log_every={seg}"])
    out = []
    for route in args.turns.split(","):
        forced_route(route)
        s = run(cfg, verbose=False)
        steady = s.segment_seconds[2:]
        rate = seg * cfg.sampler.n_chains * len(steady) / sum(steady)
        rec = {"route": route, "chain_steps_per_s": rate,
               "segment_seconds": list(s.segment_seconds),
               "accept": s.accept_rate}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    print(f"card: {card}")
    print(json.dumps({"turns": [(r["route"], round(r["chain_steps_per_s"], 2))
                                for r in out]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
