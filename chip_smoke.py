"""Smoke run of mceik_tpu on NVIDIA GPUs: the quickest proof that the
system starts, solves and samples correctly on the card.

    python chip_smoke.py             # one card, phases 1-6 below
    python chip_smoke.py --chips 4   # the two sharded paths on a 4-card
                                     # mesh, each against one card

One card:
  1. device: the card's name and power limit, JAX's view of it;
  2. solver parity at c2 width (64^3, 8 chains x 8 sources): the
     production route (the GPU sweep kernel) against the plain XLA sweep
     on the card and against the C++ FSM oracle on the host, plus the c3
     and c5 field shapes;
  3. kernel against XLA: ms per batched solve at c2's shape, B = 64 and
     B = 128;
  4. the main path: c2 through ``python -m mceik_tpu run`` (``cli.main``)
     at its config's sizes, step counts cut;
  5. a tiny c2 run on the GPU and on the host CPU in this process, whose
     logposts must agree;
  6. the other deployments at their config sizes, a few steps each: c1
     (RWM, 2-D), c3 (NUTS, joint; plus one gradient, GPU against CPU), c4
     (SMC, 10,000 particles, 2 stages), and the Laplace covariance of the
     c2 posterior against float64 NumPy.

Every phase raises on failure, so the script exits non-zero; it never
falls back to the CPU, and exits at once when JAX finds no GPU. The last
line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
C2 = os.path.join(REPO, "configs", "c2_checkerboard3d.json")


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return " | ".join(out.splitlines())


class _Tee(io.TextIOBase):
    """Pass writes through to ``stream`` and keep the lines."""

    def __init__(self, stream):
        self.stream, self.lines, self._buf = stream, [], ""

    def write(self, s):
        self.stream.write(s)
        self._buf += s
        *done, self._buf = self._buf.split("\n")
        self.lines.extend(done)
        return len(s)

    def flush(self):
        self.stream.flush()


def run_cli(args):
    """``cli.main(args)``; returns the JSON records it logged."""
    from mceik_tpu.cli import main as cli_main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli_main(args)
    if rc != 0:
        raise RuntimeError(f"cli.main{args} returned {rc}")
    return [json.loads(ln.split(" ", 1)[1]) for ln in tee.lines
            if ln.startswith("[mceik] ")]


def median_ms(fn, *args, n=10):
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm up
    ts = []
    for _ in range(n):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return 1e3 * statistics.median(ts)


def load(path, overrides=()):
    from mceik_tpu.io.config_io import apply_overrides, load_config

    cfg = load_config(path)
    return apply_overrides(cfg, list(overrides)) if overrides else cfg


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def c2_fields(n_chains, shape=None, seed=0):
    """c2's checkerboard truth and sources, one slowness field per chain
    (the truth times a smooth random perturbation), flattened to the
    (chains x sources) batch a logpost solves."""
    import jax
    import jax.numpy as jnp

    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.eikonal.solve import EikonalConfig

    cfg = load(C2, [f"grid.shape={list(shape)}"] if shape else [])
    grid = cfg.grid.build()
    data, truth = make_dataset(grid, cfg.data, cfg.model)
    u = jax.random.normal(jax.random.PRNGKey(seed), (n_chains, 6, 6, 6))
    pert = jax.vmap(lambda x: jax.image.resize(x, grid.shape, "linear"))(u)
    s_c = jnp.asarray(truth["slowness"])[None] * jnp.exp(0.05 * pert)
    n_src = data.src_xyz.shape[0]
    s_b = jnp.repeat(s_c, n_src, axis=0)
    srcs = jnp.tile(data.src_xyz, (n_chains, 1))
    eik = EikonalConfig(method=cfg.eikonal.method, tol=cfg.eikonal.tol,
                        max_iters=cfg.eikonal.max_iters,
                        n_inner=cfg.eikonal.n_inner,
                        seed_radius=cfg.eikonal.seed_radius)
    return grid, eik, s_b, srcs


def solvers(grid, eik):
    """(production route, kernel, plain XLA) as jitted functions."""
    import jax

    from mceik_tpu.eikonal import batched
    from mceik_tpu.eikonal.solve import seed_source

    def seeded(s_b, srcs):
        return jax.vmap(lambda x, sf: seed_source(sf, x, grid,
                                                  eik.seed_radius))(srcs, s_b)

    prod = jax.jit(lambda s_b, srcs: batched.solve_eikonal_batched(
        s_b, srcs, grid, eik))
    kern = jax.jit(lambda s_b, srcs: batched.kernel_solve(
        *seeded(s_b, srcs), s_b, grid, eik))
    xla = jax.jit(lambda s_b, srcs: batched.xla_solve(
        *seeded(s_b, srcs), s_b, grid, eik))
    return prod, kern, xla


def phase_parity(res):
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from mceik_tpu.native import fsm_solve

    grid, eik, s_b, srcs = c2_fields(8)
    eik6 = dataclasses.replace(eik, tol=1e-6, max_iters=100)
    prod, _, xla = solvers(grid, eik6)
    hlo = prod.lower(s_b, srcs).as_text()
    check("__gpu$xla.gpu.triton" in hlo,
          "the production route does not call the sweep kernel")
    T = prod(s_b, srcs)
    err_xla = float(jnp.max(jnp.abs(T - xla(s_b, srcs))))
    say(f"parity c2 {grid.shape} B={T.shape[0]} tol 1e-6: kernel route vs "
        f"XLA sweep on the card max|dT|={err_xla:.3e} (tolerance 1e-3)")
    check(err_xla <= 1e-3, "kernel vs XLA parity")
    err_fsm = 0.0
    for i in (0, T.shape[0] - 1):
        T_cpp, _ = fsm_solve(np.asarray(s_b[i]), np.asarray(srcs[i]), grid,
                             tol=1e-8, max_passes=100)
        err_fsm = max(err_fsm, float(np.max(np.abs(np.asarray(T[i]) - T_cpp))))
    say(f"parity c2 2 fields: kernel route vs C++ FSM oracle on the host "
        f"max|dT|={err_fsm:.3e} (tolerance 2e-3)")
    check(err_fsm <= 2e-3, "kernel vs FSM parity")
    res["parity"] = {"c2_vs_xla": err_xla, "c2_vs_fsm": err_fsm}
    for name, shape in (("c3", (48, 48, 32)), ("c5", (128, 128, 128))):
        grid, eik, s_b, srcs = c2_fields(1, shape=shape, seed=1)
        s_b, srcs = s_b[:2], srcs[:2]
        eik5 = dataclasses.replace(eik, tol=1e-5, max_iters=100)
        prod, _, xla = solvers(grid, eik5)
        err = float(jnp.max(jnp.abs(prod(s_b, srcs) - xla(s_b, srcs))))
        say(f"parity {name} field shape {shape} B=2 tol 1e-5: kernel route "
            f"vs XLA max|dT|={err:.3e} (tolerance 1e-3)")
        check(err <= 1e-3, f"{name}-shape kernel vs XLA parity")
        res["parity"][f"{name}_shape_vs_xla"] = err
    say("precision: the solver is fp32 throughout and has no dot products")


def phase_timing(res, card):
    out = {}
    for n_chains in (8, 16):
        grid, eik, s_b, srcs = c2_fields(n_chains, seed=n_chains)
        _, kern, xla = solvers(grid, eik)
        B = s_b.shape[0]
        out[f"kernel_ms_B{B}"] = median_ms(kern, s_b, srcs)
        out[f"xla_ms_B{B}"] = median_ms(xla, s_b, srcs)
    say(f"timing [{card}] c2 64^3 tol {eik.tol} n_inner {eik.n_inner}, "
        "median of 10 batched solves (ms): "
        + ", ".join(f"{k}={v:.3f}" for k, v in out.items()))
    res["timing"] = out


def phase_main(res):
    import jax
    import numpy as np

    recs = run_cli(["run", C2, "sampler.n_warmup=20", "sampler.n_samples=40",
                    "sampler.thin=4", "io.log_every=20"])
    lp = [r["logpost_mean"] for r in recs]
    acc = [r["accept"] for r in recs]
    check(len(recs) >= 2 and all(np.isfinite(lp)), f"logpost_mean {lp}")
    check(lp[-1] > lp[0], f"logpost_mean not rising: {lp}")
    check(all(0.0 < a < 1.0 for a in acc), f"acceptance {acc}")
    check("chain_steps_per_s" in recs[-1], "no chain_steps_per_s")
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    say(f"main path c2: logpost_mean {lp}, accept {acc}, "
        f"chain_steps_per_s {recs[-1]['chain_steps_per_s']} (wall clock "
        f"from the first segment, compilation included), "
        f"peak_bytes_in_use {peak}")
    res["main"] = {"logpost_mean": lp, "accept": acc, "peak_bytes": peak,
                   "chain_steps_per_s": recs[-1]["chain_steps_per_s"]}


def phase_cpu_vs_gpu(res):
    import jax
    import numpy as np

    from mceik_tpu.api import run

    cfg = load(C2, ["sampler.n_chains=1", "data.n_rec=5",
                    "sampler.n_warmup=4", "sampler.n_samples=8",
                    "sampler.thin=2", "io.log_every=4"])
    gpu = np.asarray(run(cfg, verbose=False).result.logpost_trace)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = np.asarray(run(cfg, verbose=False).result.logpost_trace)
    rel = float(np.max(np.abs(gpu - cpu) / np.abs(cpu)))
    say(f"GPU vs CPU logpost (tiny c2 probe): gpu {gpu.ravel().tolist()} "
        f"cpu {cpu.ravel().tolist()} max relative diff {rel:.3e} "
        "(tolerance 1e-4)")
    check(rel <= 1e-4, "GPU vs CPU logpost")
    res["gpu_vs_cpu_logpost_rel"] = rel


def phase_others(res):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mceik_tpu.datasets import make_dataset
    from mceik_tpu.model.laplace import (covariance_from_terms,
                                         gauss_newton_terms, map_estimate)
    from mceik_tpu.model.posterior import build_posterior
    from mceik_tpu.samplers.smc import run_smc_config

    # c1: 2-D crosswell, RWM.
    recs = run_cli(["run", os.path.join(REPO, "configs", "c1_crosswell.json"),
                    "sampler.n_warmup=20", "sampler.n_samples=20",
                    "sampler.thin=2", "io.log_every=10"])
    check(all(np.isfinite(r["logpost_mean"]) for r in recs), "c1 logpost")
    say(f"c1 RWM: logpost_mean {[r['logpost_mean'] for r in recs]}")

    # c3: joint NUTS, then one gradient of logpost on the GPU and the CPU.
    c3 = os.path.join(REPO, "configs", "c3_joint_events.json")
    recs = run_cli(["run", c3, "sampler.n_warmup=4", "sampler.n_samples=4",
                    "sampler.thin=2", "sampler.max_tree_depth=3",
                    "io.log_every=4"])
    check(all(np.isfinite(r["logpost_mean"]) for r in recs), "c3 logpost")
    say(f"c3 NUTS: logpost_mean {[r['logpost_mean'] for r in recs]}")

    def c3_grad():
        cfg = load(c3)
        grid = cfg.grid.build()
        data, _ = make_dataset(grid, cfg.data, cfg.model)
        post = build_posterior(cfg.model, data, grid, cfg.eikonal,
                               differentiable=True)
        params = post.init_params(jax.random.PRNGKey(3))
        g = jax.jit(jax.grad(post.logpost))(params)
        return np.concatenate([np.ravel(x) for x in jax.tree.leaves(g)])

    g_gpu = c3_grad()
    with jax.default_device(jax.devices("cpu")[0]):
        g_cpu = c3_grad()
    rel = float(np.linalg.norm(g_gpu - g_cpu) / np.linalg.norm(g_cpu))
    say(f"c3 grad logpost GPU vs CPU: relative L2 {rel:.3e} "
        "(tolerance 1e-3)")
    check(rel <= 1e-3, "c3 gradient GPU vs CPU")

    # c4: tempered SMC, 10,000 particles, 2 stages.
    t = time.perf_counter()
    smc = run_smc_config(load(os.path.join(REPO, "configs", "c4_smc.json")),
                         max_stages=2)
    check(smc.n_stages == 2 and np.isfinite(smc.log_evidence)
          and 0 < smc.betas[1] < smc.betas[2], f"c4 SMC {smc.betas}")
    say(f"c4 SMC: betas {smc.betas} logZ {smc.log_evidence:.4f} "
        f"wall {time.perf_counter() - t:.1f}s (compilation included)")

    # Laplace covariance of the c2 posterior, against float64 NumPy.
    cfg = load(C2)
    grid = cfg.grid.build()
    data, _ = make_dataset(grid, cfg.data, cfg.model)
    post = build_posterior(cfg.model, data, grid, cfg.eikonal,
                           differentiable=True)
    params, _ = map_estimate(post, n_steps=5, chunk=5)
    J, w, pp, act = gauss_newton_terms(post, params)
    C = np.asarray(jax.jit(covariance_from_terms)(J, w, pp, act))
    J64, w64, pp64 = (np.asarray(x, np.float64) for x in (J, w, pp))
    a64 = np.asarray(act, np.float64)
    H64 = np.diag(pp64) + (J64.T * w64[None, :]) @ J64
    C64 = np.linalg.inv(H64) * a64[:, None] * a64[None, :] + np.diag(1 - a64)
    H = np.asarray(jnp.diag(pp) + jax.jit(lambda J, w: jnp.matmul(
        J.T * w[None, :], J, precision=jax.lax.Precision.HIGHEST))(J, w))
    h_rel = float(np.max(np.abs(H - H64)) / np.max(np.abs(H64)))
    c_rel = float(np.max(np.abs(C - C64)) / np.max(np.abs(C64)))
    # An fp32 inverse loses about cond(H) * 2^-24 even when H is exact.
    cond = float(np.linalg.cond(H64))
    c_tol = 1e-3 + 4 * cond * 2.0 ** -24
    say(f"Laplace c2 (d={C.shape[0]}, n_obs={J.shape[0]}): GN Hessian vs "
        f"float64 max rel {h_rel:.3e} (tolerance 1e-5; TF32 would be ~1e-3);"
        f" covariance max rel {c_rel:.3e} (tolerance {c_tol:.3e} = 1e-3 + "
        f"4 cond(H) 2^-24, cond(H) {cond:.3e})")
    check(h_rel <= 1e-5 and c_rel <= c_tol, "Laplace covariance vs float64")
    res["laplace"] = {"hessian_rel": h_rel, "cov_rel": c_rel, "cond": cond}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_four_cards(res, n):
    import jax
    import numpy as np

    from mceik_tpu.api import run
    from mceik_tpu.samplers.smc import run_smc_config

    check(len(jax.devices()) == n, f"{len(jax.devices())} devices, want {n}")

    # c2 AM, 32 chains, no warmup: the chains never interact, so the
    # sharded run must reproduce the one-card run chain for chain.
    am = ["sampler.n_chains=32", "sampler.n_warmup=0", "sampler.n_samples=40",
          "sampler.thin=4", "io.log_every=10"]
    runs = {}
    for label, extra in (("one_card", ["dist.n_devices=1"]), ("mesh", [])):
        s = run(load(C2, am + extra), verbose=False)
        devs = s.result.states.logpost.sharding.device_set
        steady = s.segment_seconds[2:]
        rate = 10 * 32 * len(steady) / sum(steady)
        runs[label] = (s, len(devs), rate)
        say(f"c2 AM 32 chains [{label}]: states on {len(devs)} device(s), "
            f"steady chain_steps_per_s {rate:.2f}")
    (s1, d1, r1), (s4, d4, r4) = runs["one_card"], runs["mesh"]
    check(d1 == 1 and d4 == n, "chain states not spread over the mesh")
    # Each chain's logpost is computed by the same kernels on either
    # layout, but a sum taken in another order moves a logpost of ~1e5 by
    # a few 1e-2 and can flip an accept decision; a chain that flips
    # follows its own trajectory from there. So most chains, not all, must
    # agree to fp32 precision, and the pooled logpost closely.
    lp1 = np.asarray(s1.result.logpost_trace)
    lp4 = np.asarray(s4.result.logpost_trace)
    rel = np.max(np.abs(lp4 - lp1) / np.abs(lp1), axis=0)
    agree = float(np.mean(rel <= 1e-5))
    pooled = float(abs(lp4[-1].mean() - lp1[-1].mean()) / abs(lp1[-1].mean()))
    say(f"c2 AM mesh vs one card: {agree:.3f} of chains agree to 1e-5 "
        f"relative over the whole trace (tolerance >= 0.75), final pooled "
        f"logpost rel diff {pooled:.3e} (tolerance 1e-2); "
        f"chain_steps_per_s one card {r1:.2f}, {n} cards {r4:.2f}")
    check(agree >= 0.75 and pooled <= 1e-2, "c2 AM mesh vs one card")

    # c4 SMC, 2 stages: particles sharded over the mesh vs one card.
    c4 = os.path.join(REPO, "configs", "c4_smc.json")
    smc = {}
    for label, extra in (("one_card", ["dist.n_devices=1"]), ("mesh", [])):
        cfg = load(c4, extra)
        t = time.perf_counter()
        r = run_smc_config(cfg, verbose=False, max_stages=2)
        wall = time.perf_counter() - t
        devs = r.state.log_lik.sharding.device_set
        steps = (cfg.sampler.n_particles * cfg.sampler.n_mutation_steps
                 * r.n_stages)
        smc[label] = (r, len(devs))
        say(f"c4 SMC [{label}]: particles on {len(devs)} device(s), betas "
            f"{r.betas}, logZ {r.log_evidence:.5f}, {steps / wall:.1f} "
            "particle-mutation-steps/s (compilation included)")
    (m1, e1), (m4, e4) = smc["one_card"], smc["mesh"]
    check(e1 == 1 and e4 == n, "particles not spread over the mesh")
    # As with AM, a sum taken in another order can flip a mutation's
    # accept decision, and the two populations then differ by Monte Carlo
    # noise: compare at that precision (pooled means within 5 standard
    # errors of a difference of two N-particle means).
    db = float(np.max(np.abs(np.diff(m4.betas) - np.diff(m1.betas))
                      / np.diff(m1.betas)))
    dz = abs(m4.log_evidence - m1.log_evidence)
    u1 = np.asarray(m1.state.params.u).reshape(len(m1.state.log_lik), -1)
    u4 = np.asarray(m4.state.params.u).reshape(len(m4.state.log_lik), -1)
    se = np.sqrt(2.0 * u1.var(axis=0) / u1.shape[0]) + 1e-12
    z = float(np.max(np.abs(u4.mean(axis=0) - u1.mean(axis=0)) / se))
    say(f"c4 SMC mesh vs one card: beta increments max rel diff {db:.3e} "
        f"(tolerance 1e-2), logZ diff {dz:.3e} (tolerance 1e-2), pooled "
        f"mean u max |diff| / standard error {z:.3f} (tolerance 5)")
    check(db <= 1e-2 and dz <= 1e-2 and z <= 5.0, "c4 SMC mesh vs one card")
    res["four_cards"] = {"am_agree": agree, "am_pooled_rel": pooled,
                         "am_rate_one": r1, "am_rate_mesh": r4,
                         "smc_dbeta": db, "smc_dlogz": dz, "smc_mean_z": z}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded paths on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev}); "
              "this script never falls back to the CPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from mceik_tpu.cli import enable_compile_cache

    cache = enable_compile_cache()
    card = card_line()
    say(f"card: {card}")
    say(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind} "
        f"({dev.platform}); XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache}")

    res = {}
    if args.chips == 1:
        phases = [("solver parity", lambda: phase_parity(res)),
                  ("kernel vs XLA timing", lambda: phase_timing(res, card)),
                  ("main path c2", lambda: phase_main(res)),
                  ("GPU vs CPU logpost", lambda: phase_cpu_vs_gpu(res)),
                  ("c1, c3, c4, Laplace", lambda: phase_others(res))]
    else:
        phases = [("four cards", lambda: phase_four_cards(res, args.chips))]
    for i, (name, fn) in enumerate(phases, start=2 if args.chips == 1 else 1):
        t = time.perf_counter()
        say(f"== phase {i}: {name}")
        fn()
        say(f"== phase {i} done in {time.perf_counter() - t:.1f}s")
    say(f"card: {card}")
    say(json.dumps({"results": res}))
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
