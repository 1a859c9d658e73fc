"""Iterative, fixed-budget, vmap-safe NUTS (SURVEY.md §2.1 "HMC/NUTS",
§3.3, §7 M5 hard-part 3).

Recursive NUTS is unusable under ``vmap`` (data-dependent recursion),
so this is the iterative multinomial formulation: the trajectory doubles
up to ``max_tree_depth`` times; each doubling simulates ``2^d`` leapfrog
steps sequentially with

- an O(max_tree_depth) *checkpoint stack* for sub-tree U-turn checks: a
  complete binary subtree of size ``2^k`` ends at in-subtree leaf ``i`` iff
  ``(i+1) % 2^k == 0``; its first leaf is the last stored level-k block
  start (slot ``k``), so one (z, r) slot per level suffices;
- online multinomial (reservoir) sampling of the proposal with running
  log-weights ``log w = H0 - H``;
- divergence detection (energy error > 1000) and the generalized U-turn
  criterion ``(z+ - z-).(M^-1 r∓) < 0`` on forward-time momenta (leapfrog
  with a negative step integrates backward in time, so stored momenta are
  always forward-time; subtree deltas are sign-corrected by direction).

Every chain always runs the full ``2^max_tree_depth - 1`` leapfrog budget
(stopped chains mask their updates) — the price of lockstep vmap, paid
deliberately: wasted FLOPs beat divergent control flow across chains.

Step size / mass matrix adaptation reuses hmc.py's dual averaging +
pooled-Welford machinery (hmc.make_adapter / hmc.finalize).
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from mceik_tpu.samplers.base import MHState
from mceik_tpu.samplers.hmc import HMCHyper, kinetic
from mceik_tpu.utils import tree_axpy, tree_dot, tree_random_normal, tree_where


def _leapfrog_step(value_and_grad, z, r, g, eps, inv_mass):
    """One leapfrog step (eps may be negative = backward in time).
    Returns (z, r, logpost, grad)."""
    r = tree_axpy(0.5 * eps, g, r)
    z = jax.tree.map(lambda zi, ri, mi: zi + eps * mi * ri, z, r, inv_mass)
    lp, g = value_and_grad(z)
    r = tree_axpy(0.5 * eps, g, r)
    return z, r, lp, g


def _turn(dz, r_a, r_b, inv_mass):
    """Generalized U-turn test for endpoints with forward-time momenta."""
    va = jax.tree.map(lambda m, r: m * r, inv_mass, r_a)
    vb = jax.tree.map(lambda m, r: m * r, inv_mass, r_b)
    return jnp.logical_or(tree_dot(dz, va) < 0.0, tree_dot(dz, vb) < 0.0)


def make_kernel(logpost_fn: Callable, max_tree_depth: int = 6,
                divergence_threshold: float = 1000.0) -> Callable:
    value_and_grad = jax.value_and_grad(logpost_fn)

    def kernel(key, state: MHState, hyper: HMCHyper):
        inv_mass = hyper.inv_mass
        eps = jnp.exp(hyper.da.log_eps)
        k_mom, k_loop = jax.random.split(key)

        # Momentum draw r ~ N(0, M), M = diag(1/inv_mass).
        xi = tree_random_normal(k_mom, state.params)
        r0 = jax.tree.map(lambda x, mi: x * lax.rsqrt(jnp.maximum(mi, 1e-12)),
                          xi, inv_mass)
        lp0 = state.logpost
        g0 = jax.grad(logpost_fn)(state.params)
        H0 = -lp0 + kinetic(r0, inv_mass)

        # Checkpoint stacks: one (z, r) slot per level.
        def stack_of(t):
            return jax.tree.map(
                lambda x: jnp.broadcast_to(x, (max_tree_depth,) + x.shape).copy(), t)

        carry = dict(
            z_minus=state.params, r_minus=r0, z_plus=state.params, r_plus=r0,
            g_minus=g0, g_plus=g0,
            z_prop=state.params, lp_prop=lp0,
            log_w_total=jnp.asarray(0.0, jnp.float32),  # log w rel. exp(-H0)
            stopped=jnp.asarray(False),
            diverged=jnp.asarray(False),
            moved=jnp.asarray(False),
            accept_sum=jnp.asarray(0.0, jnp.float32),
            n_leaves=jnp.asarray(0.0, jnp.float32),
            depth_reached=jnp.asarray(0, jnp.int32),
            key=k_loop,
        )

        for depth in range(max_tree_depth):
            n_sub = 2 ** depth
            key_d, key_dir, key_acc = jax.random.split(carry["key"], 3)
            carry["key"] = key_d
            go_right = jax.random.bernoulli(key_dir)
            dir_ = jnp.where(go_right, 1.0, -1.0)

            z0 = tree_where(go_right, carry["z_plus"], carry["z_minus"])
            r0_ = tree_where(go_right, carry["r_plus"], carry["r_minus"])
            g0_ = tree_where(go_right, carry["g_plus"], carry["g_minus"])

            sub = dict(
                z=z0, r=r0_, g=g0_,
                zc=stack_of(z0), rc=stack_of(r0_),
                z_sub=z0, lp_sub=jnp.asarray(0.0, jnp.float32),
                log_w_sub=jnp.asarray(-jnp.inf, jnp.float32),
                turned=jnp.asarray(False),
                diverged=jnp.asarray(False),
                accept_sum=jnp.asarray(0.0, jnp.float32),
                key=jax.random.fold_in(key_d, depth),
            )

            def leaf_body(i, sub):
                z, r, lp, g = _leapfrog_step(value_and_grad, sub["z"], sub["r"],
                                             sub["g"], dir_ * eps, inv_mass)
                H = -lp + kinetic(r, inv_mass)
                dH = H0 - H
                dH = jnp.where(jnp.isfinite(dH), dH, -jnp.inf)
                diverged = dH < -divergence_threshold
                accept_stat = jnp.exp(jnp.minimum(dH, 0.0))

                # Reservoir multinomial sampling within the subtree.
                key_i = jax.random.fold_in(sub["key"], i)
                log_w_new = jnp.logaddexp(sub["log_w_sub"], dH)
                take = jnp.log(jax.random.uniform(key_i)) < (dH - log_w_new)
                z_sub = tree_where(take, z, sub["z_sub"])
                lp_sub = jnp.where(take, lp, sub["lp_sub"])

                # Store block-start checkpoints: slot k gets (z, r) when
                # i % 2^k == 0 (this leaf begins a level-k block). Level-k
                # blocks are disjoint, so one slot per level suffices.
                ks = jnp.arange(max_tree_depth)
                should_store = (i % (2 ** ks)) == 0  # (max_tree_depth,)

                def store(stack, leaf):
                    return jax.tree.map(
                        lambda arr, x: jnp.where(
                            should_store.reshape(
                                (max_tree_depth,) + (1,) * x.ndim),
                            jnp.broadcast_to(x, arr.shape), arr),
                        stack, leaf)

                zc = store(sub["zc"], z)
                rc = store(sub["rc"], r)

                # Sub-tree U-turn checks: for every k>=1 with (i+1) % 2^k == 0,
                # compare with slot k's stored start.
                ends_block = ((i + 1) % (2 ** ks) == 0) & (ks >= 1) & (ks <= depth)

                def check_k(k):
                    zk = jax.tree.map(lambda a: a[k], zc)
                    rk = jax.tree.map(lambda a: a[k], rc)
                    dz = jax.tree.map(lambda a, b: dir_ * (a - b), z, zk)
                    return _turn(dz, rk, r, inv_mass)

                turned_any = jnp.asarray(False)
                for k in range(1, max_tree_depth):
                    turned_any = jnp.logical_or(
                        turned_any, jnp.logical_and(ends_block[k], check_k(k)))

                active = jnp.logical_not(jnp.logical_or(sub["turned"],
                                                        sub["diverged"]))
                new = dict(
                    z=z, r=r, g=g, zc=zc, rc=rc,
                    z_sub=z_sub, lp_sub=lp_sub, log_w_sub=log_w_new,
                    turned=jnp.logical_or(sub["turned"], turned_any),
                    diverged=jnp.logical_or(sub["diverged"], diverged),
                    accept_sum=sub["accept_sum"] + accept_stat,
                    key=sub["key"],
                )
                # Frozen once inactive (turned/diverged mid-subtree).
                out = {}
                for name in sub:
                    if name in ("turned", "diverged"):
                        out[name] = new[name]
                    elif name == "key":
                        out[name] = sub[name]
                    else:
                        out[name] = tree_where(active, new[name], sub[name])
                return out

            sub = lax.fori_loop(0, n_sub, leaf_body, sub)

            # Subtree accepted only if the whole doubling is clean AND the
            # chain hadn't already stopped.
            was_active = jnp.logical_not(carry["stopped"])
            clean = jnp.logical_not(jnp.logical_or(sub["turned"], sub["diverged"]))
            use = jnp.logical_and(was_active, clean)

            # Biased-progressive acceptance of the new subtree's proposal.
            log_ratio = sub["log_w_sub"] - carry["log_w_total"]
            take_new = jnp.log(jax.random.uniform(key_acc)) < log_ratio
            take_new = jnp.logical_and(use, take_new)
            carry["z_prop"] = tree_where(take_new, sub["z_sub"], carry["z_prop"])
            carry["lp_prop"] = jnp.where(take_new, sub["lp_sub"], carry["lp_prop"])
            carry["moved"] = jnp.logical_or(carry["moved"], take_new)
            carry["log_w_total"] = jnp.where(
                use, jnp.logaddexp(carry["log_w_total"], sub["log_w_sub"]),
                carry["log_w_total"])

            # Extend the overall trajectory endpoint on the chosen side.
            upd_plus = jnp.logical_and(use, go_right)
            upd_minus = jnp.logical_and(use, jnp.logical_not(go_right))
            carry["z_plus"] = tree_where(upd_plus, sub["z"], carry["z_plus"])
            carry["r_plus"] = tree_where(upd_plus, sub["r"], carry["r_plus"])
            carry["g_plus"] = tree_where(upd_plus, sub["g"], carry["g_plus"])
            carry["z_minus"] = tree_where(upd_minus, sub["z"], carry["z_minus"])
            carry["r_minus"] = tree_where(upd_minus, sub["r"], carry["r_minus"])
            carry["g_minus"] = tree_where(upd_minus, sub["g"], carry["g_minus"])

            # Overall U-turn across the full trajectory.
            dz = jax.tree.map(lambda a, b: a - b, carry["z_plus"], carry["z_minus"])
            overall_turn = _turn(dz, carry["r_minus"], carry["r_plus"], inv_mass)

            carry["accept_sum"] = carry["accept_sum"] + jnp.where(
                was_active, sub["accept_sum"], 0.0)
            carry["n_leaves"] = carry["n_leaves"] + jnp.where(was_active,
                                                              float(n_sub), 0.0)
            carry["depth_reached"] = jnp.where(was_active, depth + 1,
                                               carry["depth_reached"])
            carry["diverged"] = jnp.logical_or(carry["diverged"],
                                               jnp.logical_and(was_active,
                                                               sub["diverged"]))
            carry["stopped"] = jnp.logical_or(
                carry["stopped"],
                jnp.logical_or(jnp.logical_not(clean), overall_turn))

        accept_prob = carry["accept_sum"] / jnp.maximum(carry["n_leaves"], 1.0)
        info = {"accept_prob": accept_prob,
                # Explicit took-a-subtree flag — inferring movement from
                # lp_prop != logpost false-negatives on equal logposts.
                "accepted": carry["moved"].astype(jnp.float32),
                "divergent": carry["diverged"].astype(jnp.float32),
                "tree_depth": carry["depth_reached"].astype(jnp.float32)}
        return MHState(params=carry["z_prop"], logpost=carry["lp_prop"]), info

    return kernel
