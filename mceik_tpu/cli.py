"""Command-line entry point (SURVEY.md §1 L7).

Usage:
    python -m mceik_tpu run configs/c1_crosswell.json [section.key=value ...]
    python -m mceik_tpu print-config configs/c1_crosswell.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from mceik_tpu.io.config_io import apply_overrides, config_to_dict, load_config

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Keep XLA's persistent compile cache across runs; returns its path.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and
    nothing is set here. Otherwise the cache lives at the fixed path
    ``<repo>/.jax_cache`` (the path is part of the cache key, so it must
    not move between runs).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mceik_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a sampling workload from a config")
    runp.add_argument("config", help="path to JSON config")
    runp.add_argument("overrides", nargs="*",
                      help="dotted overrides, e.g. sampler.n_samples=2000")

    pc = sub.add_parser("print-config", help="print the resolved config")
    pc.add_argument("config")
    pc.add_argument("overrides", nargs="*")

    args = p.parse_args(argv)
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)

    if args.cmd == "print-config":
        json.dump(config_to_dict(cfg), sys.stdout, indent=2)
        print()
        return 0

    if args.cmd == "run":
        enable_compile_cache()
        if cfg.sampler.algorithm == "smc":
            from mceik_tpu.samplers.smc import run_smc_config
            run_smc_config(cfg)
        else:
            from mceik_tpu.api import run
            run(cfg)
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
