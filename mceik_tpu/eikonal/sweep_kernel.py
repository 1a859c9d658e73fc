"""Pallas (Triton) kernel for the batched 3-D plane-sweep solve on the GPU.

Computes exactly what ``solve._sweep_solve`` computes — the same cycles of
2*D directional Gauss-Seidel plane sweeps with ``n_inner`` in-plane Jacobi
micro-iterations, the same ``godunov.local_solve`` arithmetic, the same
``max|dT| <= tol`` stopping rule — for a flat batch of fields, with one
program (thread block) per field and the whole convergence loop inside the
kernel. Each field therefore stops at its own cycle count, and a batched
solve costs one launch instead of the XLA path's launch (and loop-predicate
round trip) per plane step.

Design, per program:

- The field lives in device memory; the plane being updated is held in
  registers (planes of up to ``CHUNK`` padded elements — 64^3 and
  48x48x32 fields) or streamed through them one row chunk at a time
  (128^3). Its in-plane neighbours are read back through masked loads at
  +-1 offsets (out-of-field reads give ``BIG``). Micro-iterations
  ping-pong between two plane-sized scratch buffers, so every
  micro-iteration reads only the previous one's values (Jacobi in the
  plane, as in the reference) and no chunk reads a row that another chunk
  has already rewritten. A block barrier separates a micro-iteration's
  stores from the next one's loads.
- The frozen source seeds are restored with ``max(candidate, floor)``
  (``floor`` = seed value on seeded nodes, 0 elsewhere): monotone updates
  only ever push a seeded node below its seed and traveltimes are >= 0,
  so this equals the reference's ``where(frozen, T0, T)`` bit for bit.
- Plane layouts keep loads coalesced: sweeps along x and y read planes
  whose rows run along z, the contiguous axis, in the field's own (x, y, z)
  layout. The z sweep would read its (x, y) planes with a stride of n_z,
  so before it the program copies the field into a (z, x, y) scratch copy
  and after it copies back (s and the floor are transposed once, outside).
  The copy back also takes ``max|T_new - T_start|`` for the stopping rule
  against a start-of-cycle copy of the field.

``interpret=True`` runs the kernel in the Pallas interpreter (tests only).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from mceik_tpu.eikonal.godunov import BIG, local_solve

# Largest plane tile held in registers (padded elements), and warps per
# program: 16 warps give 8 elements of a 4096-element tile per thread.
CHUNK = 4096
NUM_WARPS = 16


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _tiling(nu: int, nv: int):
    """Padded plane tile: (rows per chunk, padded row length, n_chunks)."""
    pv = _pow2(nv)
    pu = _pow2(nu)
    rows = max(1, min(pu, CHUNK // pv))
    return rows, pv, pu // rows


def _barrier(interpret: bool):
    # The interpreter runs the program sequentially, so it needs (and has)
    # no barrier; on the card one orders a chunk's stores before the
    # shifted loads of the next micro-iteration.
    if not interpret:
        plt.debug_barrier()


def _load(ref, base, r, c, su, sv, nu, nv, ok=True):
    """Masked load of the tile ``ref[base + r*su + c*sv]``; nodes outside the
    (nu, nv) plane or where ``ok`` is false read ``BIG``."""
    inb = (r >= 0) & (r < nu) & (c >= 0) & (c < nv) & ok
    off = jnp.where(inb, base + r * su + c * sv, 0)
    return plt.load(ref.at[off], mask=inb, other=BIG)


def _store(ref, base, r, c, su, sv, nu, nv, val):
    # Masked-out lanes point at the buffer's last element, a sink no lane
    # reads: the interpreter writes masked lanes back with the old value,
    # which must not race a real store to the same element.
    inb = (r < nu) & (c < nv)
    off = jnp.where(inb, base + r * su + c * sv, ref.shape[0] - 1)
    plt.store(ref.at[off], val, mask=inb)


def _chunks(n_chunks: int, body):
    if n_chunks == 1:
        body(0)
    else:
        def step(c, carry):
            body(c)
            return carry

        lax.fori_loop(0, n_chunks, step, 0)


def _march(W, s_ref, f_ref, pp, geom, n_inner, interpret):
    """Forward then backward Gauss-Seidel march along one axis, in place.

    ``geom = (cnt, stride, nu, su, nv, sv, spacing)``: number of planes and
    their stride, the two in-plane axes (count, stride) and the spacing in
    (swept, u, v) order — the argument order of the reference's
    ``local_solve`` call after it moves the swept axis to the front.
    """
    cnt, stride, nu, su, nv, sv, spacing = geom
    rows, pv, n_chunks = _tiling(nu, nv)
    if n_chunks == 1:
        for direction in (1, -1):
            _march_resident(W, s_ref, f_ref, pp, geom, n_inner, interpret,
                            direction)
        return
    plane = nu * nv
    r0 = lax.broadcasted_iota(jnp.int32, (rows, pv), 0)
    col = lax.broadcasted_iota(jnp.int32, (rows, pv), 1)

    def micro(p, src, dst):
        (src_ref, s_base, s_su, s_sv) = src
        (d_ref, d_base, d_su, d_sv) = dst
        base = p * stride

        def chunk(c):
            r = r0 + c * rows
            ctr = _load(src_ref, s_base, r, col, s_su, s_sv, nu, nv)
            a_u = jnp.minimum(
                _load(src_ref, s_base, r - 1, col, s_su, s_sv, nu, nv),
                _load(src_ref, s_base, r + 1, col, s_su, s_sv, nu, nv))
            a_v = jnp.minimum(
                _load(src_ref, s_base, r, col - 1, s_su, s_sv, nu, nv),
                _load(src_ref, s_base, r, col + 1, s_su, s_sv, nu, nv))
            a_ax = jnp.minimum(
                _load(W, base - stride, r, col, su, sv, nu, nv, p >= 1),
                _load(W, base + stride, r, col, su, sv, nu, nv, p <= cnt - 2))
            s = _load(s_ref, base, r, col, su, sv, nu, nv)
            floor = _load(f_ref, base, r, col, su, sv, nu, nv)
            t = jnp.minimum(ctr, local_solve([a_ax, a_u, a_v], spacing, s))
            _store(d_ref, d_base, r, col, d_su, d_sv, nu, nv,
                   jnp.maximum(t, floor))

        _chunks(n_chunks, chunk)
        _barrier(interpret)

    def update_plane(k, carry):
        # k in [0, 2*cnt): forward march, then the same planes reversed.
        p = jnp.where(k < cnt, k, 2 * cnt - 1 - k)
        field = (W, p * stride, su, sv)
        bufs = [(pp, 0, nv, 1), (pp, plane, nv, 1)]
        chain = [field] + [bufs[m % 2] for m in range(n_inner - 1)]
        chain.append(field if n_inner > 1 else bufs[0])
        for m in range(n_inner):
            micro(p, chain[m], chain[m + 1])
        if n_inner == 1:
            _copy_plane(pp, 0, nv, 1, W, p * stride, su, sv, nu, nv,
                        rows, pv, n_chunks, r0, col)
            _barrier(interpret)
        return carry

    lax.fori_loop(0, 2 * cnt, update_plane, 0)


def _march_resident(W, s_ref, f_ref, pp, geom, n_inner, interpret,
                    direction):
    """One directional march of planes that fit one register tile.

    The tiles a plane update needs besides its in-plane neighbours ride in
    the loop carry: the just-updated upstream plane, the plane's own old
    values (loaded one step earlier as the downstream neighbour), and the
    next step's downstream plane, slowness and floor, whose loads are
    issued a step ahead so that their latency overlaps this plane's work.
    """
    cnt, stride, nu, su, nv, sv, spacing = geom
    rows, pv, _ = _tiling(nu, nv)
    plane = nu * nv
    r = lax.broadcasted_iota(jnp.int32, (rows, pv), 0)
    c = lax.broadcasted_iota(jnp.int32, (rows, pv), 1)
    first = 0 if direction > 0 else cnt - 1

    def plane_of(ref, q):
        return _load(ref, q * stride, r, c, su, sv, nu, nv,
                     (q >= 0) & (q < cnt))

    def step(i, carry):
        up, ctr, down, s, floor = carry
        p = first + direction * i
        nxt = (plane_of(W, p + 2 * direction), plane_of(s_ref, p + direction),
               plane_of(f_ref, p + direction))
        a_ax = jnp.minimum(up, down)
        T = ctr
        src = (W, p * stride, su, sv)
        for m in range(n_inner):
            last = m == n_inner - 1
            dst = src if last and m == 0 else (
                (W, p * stride, su, sv) if last else (pp, (m % 2) * plane, nv, 1))
            ref, base, ssu, ssv = src
            a_u = jnp.minimum(_load(ref, base, r - 1, c, ssu, ssv, nu, nv),
                              _load(ref, base, r + 1, c, ssu, ssv, nu, nv))
            a_v = jnp.minimum(_load(ref, base, r, c - 1, ssu, ssv, nu, nv),
                              _load(ref, base, r, c + 1, ssu, ssv, nu, nv))
            T = jnp.maximum(
                jnp.minimum(T, local_solve([a_ax, a_u, a_v], spacing, s)),
                floor)
            if dst is src:
                # n_inner == 1 updates the plane in place: every read of
                # it must land before the first write.
                _barrier(interpret)
            ref, base, dsu, dsv = dst
            _store(ref, base, r, c, dsu, dsv, nu, nv, T)
            _barrier(interpret)
            src = dst
        return (T, down) + nxt

    init = (jnp.full((rows, pv), BIG, jnp.float32), plane_of(W, first),
            plane_of(W, first + direction), plane_of(s_ref, first),
            plane_of(f_ref, first))
    lax.fori_loop(0, cnt, step, init)


def _copy_plane(src, sb, ssu, ssv, dst, db, dsu, dsv, nu, nv, rows, pv,
                n_chunks, r0, col):
    def chunk(c):
        r = r0 + c * rows
        v = _load(src, sb, r, col, ssu, ssv, nu, nv)
        _store(dst, db, r, col, dsu, dsv, nu, nv, v)

    _chunks(n_chunks, chunk)


def _kernel(T0_ref, sA_ref, fA_ref, sB_ref, fB_ref,
            T_ref, TB_ref, prev_ref, pp_ref, *,
            shape, spacing, tol, max_cycles, n_inner, interpret):
    n0, n1, n2 = shape
    h0, h1, h2 = spacing
    # Field-sized copies run over x-slices, as (y rows, z columns) tiles.
    rows, pv, n_chunks = _tiling(n1, n2)
    r0 = lax.broadcasted_iota(jnp.int32, (rows, pv), 0)
    col = lax.broadcasted_iota(jnp.int32, (rows, pv), 1)
    sA = (n1 * n2, n2, 1)          # (x, y, z) strides of layout A
    sB = (n1, 1, n0 * n1)          # (x, y, z) strides of layout B = (z, x, y)

    def over_x_slices(fn):
        def body(i, carry):
            def chunk(c):
                fn(i, r0 + c * rows)
            _chunks(n_chunks, chunk)
            return carry
        lax.fori_loop(0, n0, body, 0)

    def init(i, r):
        v = _load(T0_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2)
        _store(T_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2, v)
        _store(prev_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2, v)

    def to_b(i, r):
        v = _load(T_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2)
        _store(TB_ref, i * sB[0], r, col, sB[1], sB[2], n1, n2, v)

    over_x_slices(init)
    _barrier(interpret)

    geom_x = (n0, sA[0], n1, sA[1], n2, sA[2], (h0, h1, h2))
    geom_y = (n1, sA[1], n0, sA[0], n2, sA[2], (h1, h0, h2))
    geom_z = (n2, sB[2], n0, sB[0], n1, sB[1], (h2, h0, h1))

    def cycle(carry):
        _, it = carry
        _march(T_ref, sA_ref, fA_ref, pp_ref, geom_x, n_inner, interpret)
        _march(T_ref, sA_ref, fA_ref, pp_ref, geom_y, n_inner, interpret)
        over_x_slices(to_b)
        _barrier(interpret)
        _march(TB_ref, sB_ref, fB_ref, pp_ref, geom_z, n_inner, interpret)

        def back(i, carry):
            def chunk(c, d):
                r = r0 + c * rows
                new = _load(TB_ref, i * sB[0], r, col, sB[1], sB[2], n1, n2)
                old = _load(prev_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2)
                _store(T_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2, new)
                _store(prev_ref, i * sA[0], r, col, sA[1], sA[2], n1, n2, new)
                return jnp.maximum(d, jnp.max(jnp.abs(new - old)))
            return lax.fori_loop(0, n_chunks, chunk, carry)

        delta = lax.fori_loop(0, n0, back, jnp.float32(0.0))
        _barrier(interpret)
        return delta, it + 1

    def cond(carry):
        delta, it = carry
        return (delta > tol) & (it < max_cycles)

    lax.while_loop(cond, cycle, (jnp.float32(jnp.inf), jnp.int32(0)))


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def sweep_solve_batched(T0, floor, s, spacing, tol, max_cycles, n_inner=2,
                        interpret=False):
    """Sweep solve of a flat batch of 3-D fields, one program per field.

    ``T0``, ``floor``, ``s``: ``(B, n0, n1, n2)`` float32 — initial field,
    seed floor (``where(frozen, T0, 0)``) and slowness. Same contract as
    ``vmap(solve._sweep_solve)``; returns the converged ``(B, n0, n1, n2)``.
    """
    B, n0, n1, n2 = T0.shape
    N = n0 * n1 * n2
    plane = max(n1 * n2, n0 * n2, n0 * n1)
    flat = lambda x: jnp.pad(x.astype(jnp.float32).reshape(B, N),
                             ((0, 0), (0, 1)))
    to_b = lambda x: flat(jnp.transpose(x, (0, 3, 1, 2)))
    # Every buffer carries one trailing sink element (see _store).
    field = pl.BlockSpec((None, N + 1), lambda b: (b, 0))
    kernel = functools.partial(
        _kernel, shape=(n0, n1, n2), spacing=tuple(float(h) for h in spacing),
        tol=float(tol), max_cycles=int(max_cycles), n_inner=int(n_inner),
        interpret=interpret)
    out = pl.pallas_call(
        kernel,
        grid=(B,),
        in_specs=[field] * 5,
        out_specs=[field, field, field,
                   pl.BlockSpec((None, 2 * plane + 1), lambda b: (b, 0))],
        out_shape=[jax.ShapeDtypeStruct((B, N + 1), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((B, 2 * plane + 1), jnp.float32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="eikonal_sweep_solve",
    )(flat(T0), flat(s), flat(floor), to_b(s), to_b(floor))
    return out[0][:, :N].reshape(B, n0, n1, n2)
