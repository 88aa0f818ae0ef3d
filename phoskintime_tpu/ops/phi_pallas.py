"""Pallas kernel (Triton route) for the ETD2RK propagator-table build.

The objective builds, in every call, the per-(bucket, h) propagator tables
E = expm(Lh), p1 = h phi1(Lh) e0, p2 = h^2 phi2(Lh) e0 for every
(member, protein) block. The XLA version
(:func:`phoskintime_tpu.network.expo._phi_vectors_lanes`) round-trips the
(w, w, P*N) carry through device memory at every Taylor term and every
squaring — about 1 GB per pair at pop 2048, ~14 pairs — while the work per
lane is only w^3 multiply-adds at w <= 8.

Here one program owns a block of lanes of one (bucket, h) pair. It loads
the w*w entries of its L blocks (the lane axis is minor, so every load is
coalesced), runs the scaling, the Taylor series and the doubling ladder
with every matrix entry held as a (blk,) register vector, and stores E,
p1 and p2 once. Device-memory traffic is one read of L and one write of
the tables. The Taylor stage is one Horner loop, and the ladder loops up
to the block's own largest squaring need (lanes that need fewer squarings
are masked per iteration, exactly like the XLA ladder), so there is no
static worst-case unroll.

All pairs go in ONE call over a (pair, lane block) grid; each block loads
its own bucket index from ``binv``. Block sizes are powers of two and the
lane tail is masked.

Math spec: ``network/expo.py:_phi_vectors_lanes`` (the doubling identities
E(2h) = E^2, p1(2h) = (I+E)p1, p2(2h) = (I+E)p2 + h p1). Behavioral spec
for the tables themselves: reference ``global_model/solvers.py`` +
``jacspeedup.py`` integrate the same linear blocks step by step; here they
are integrated exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from phoskintime_tpu.network.expo import (_MAX_SQUARINGS, _taylor_radius,
                                          _taylor_terms)

_RADIUS = _taylor_radius(jnp.float32)
_TERMS = _taylor_terms(jnp.float32)
# lanes per program and warps per program, chosen on an H100 SXM at the
# bench shape (w = 6, 14 pairs, ~82k lanes): 256 x 8 timed fastest of
# eight (blk, warps) pairs; see PERF.md
BLK = 256
NUM_WARPS = 8


def _phi_math(w: int, L, h):
    """Kernel math on register vectors: L[i][j] (blk,), h scalar ->
    (E [w][w], p1 [w], p2 [w]). Same scaling, series length and per-lane
    squaring mask as the XLA ladder.

    Both stages are loops, not unrolled code: the straight-line version
    (every Horner term and squaring written out, ~4.6k vector ops at
    w = 6) took 83-91 s of Triton compilation on an H100, per program
    that embeds the kernel."""
    A = [[L[i][j] * h for j in range(w)] for i in range(w)]
    norm = None                                   # per-lane inf-norm
    for i in range(w):
        row = jnp.abs(A[i][0])
        for j in range(1, w):
            row = row + jnp.abs(A[i][j])
        norm = row if norm is None else jnp.maximum(norm, row)
    s = jnp.ceil(jnp.log2(jnp.maximum(norm, 1e-30) * (1.0 / _RADIUS)))
    s = jnp.clip(s, 0.0, float(_MAX_SQUARINGS))
    inv = jnp.exp2(-s)
    A = [[A[i][j] * inv for j in range(w)] for i in range(w)]
    hs = h * inv

    def mm(x, y):
        return [[sum((x[i][j] * y[j][k] for j in range(1, w)),
                     x[i][0] * y[0][k]) for k in range(w)]
                for i in range(w)]

    def mv(M, v):
        return [sum((M[i][j] * v[j] for j in range(1, w)), M[i][0] * v[0])
                for i in range(w)]

    # one Horner loop for all three series (k = T .. 1):
    #   E  = I + A E / k          -> expm(A)
    #   v1 = e0 + A v1 / (k + 1)  -> phi1(A) e0 = sum A^k e0 / (k+1)!
    #   v2 = e0 + A v2 / (k + 2)  -> 2 phi2(A) e0 = 2 sum A^k e0 / (k+2)!
    def horner(n, carry):
        E, v1, v2 = carry
        k = (_TERMS - n).astype(jnp.float32)
        AE, Av1, Av2 = mm(A, E), mv(A, v1), mv(A, v2)
        E = [[AE[i][j] * (1.0 / k) + (1.0 if i == j else 0.0)
              for j in range(w)] for i in range(w)]
        v1 = [Av1[i] * (1.0 / (k + 1.0)) + (1.0 if i == 0 else 0.0)
              for i in range(w)]
        v2 = [Av2[i] * (1.0 / (k + 2.0)) + (1.0 if i == 0 else 0.0)
              for i in range(w)]
        return E, v1, v2

    zero = A[0][0] * 0.0
    one = zero + 1.0
    E = [[one if i == j else zero for j in range(w)] for i in range(w)]
    e0 = [one if i == 0 else zero for i in range(w)]
    E, v1, v2 = jax.lax.fori_loop(0, _TERMS, horner, (E, e0, e0))
    p1 = [v * hs for v in v1]
    p2 = [v * (0.5 * hs * hs) for v in v2]

    def square(it, carry):
        E, p1, p2, hc = carry
        go = it.astype(s.dtype) < s
        p1n = mv(E, p1)
        p2n = mv(E, p2)
        En = mm(E, E)
        E = [[jnp.where(go, En[i][j], E[i][j]) for j in range(w)]
             for i in range(w)]
        p2 = [jnp.where(go, p2[i] + p2n[i] + p1[i] * hc, p2[i])
              for i in range(w)]
        p1 = [jnp.where(go, p1[i] + p1n[i], p1[i]) for i in range(w)]
        return E, p1, p2, jnp.where(go, 2.0 * hc, hc)

    n_sq = jnp.max(s).astype(jnp.int32)           # this block's need
    E, p1, p2, _ = jax.lax.fori_loop(0, n_sq, square, (E, p1, p2, hs))
    return E, p1, p2


def _phi_kernel(w: int, n_lanes: int, blk: int, binv_ref, h_ref, L_ref,
                E_ref, p1_ref, p2_ref):
    u = pl.program_id(0)
    start = pl.program_id(1) * blk
    lanes = pl.ds(start, blk)
    mask = start + jnp.arange(blk) < n_lanes
    row0 = binv_ref[()] * (w * w)
    L = [[plt.load(L_ref.at[row0 + i * w + j, lanes], mask=mask, other=0.0)
          for j in range(w)] for i in range(w)]
    E, p1, p2 = _phi_math(w, L, h_ref[()])
    for i in range(w):
        for j in range(w):
            plt.store(E_ref.at[u * (w * w) + i * w + j, lanes], E[i][j],
                      mask=mask)
        plt.store(p1_ref.at[u * w + i, lanes], p1[i], mask=mask)
        plt.store(p2_ref.at[u * w + i, lanes], p2[i], mask=mask)


@partial(jax.jit, static_argnames=("blk", "num_warps", "interpret"))
def phi_vectors_pallas(L, binv, h_u, blk: int = BLK,
                       num_warps: int = NUM_WARPS, interpret: bool = False):
    """Tables for ALL (bucket, h) pairs in one ``pallas_call``.

    Args:
      L: (Bu, w, w, B) lane-layout f32 blocks, one slab per unique bucket.
      binv: (U,) int32 bucket index of each (bucket, h) pair.
      h_u: (U,) segment length of each pair.
      blk: lanes per program (a power of two); the tail is masked.
      num_warps: warps per program.
      interpret: run the Pallas interpreter (CPU tests only).
    Returns (E (U, w, w, B), p1 (U, w, B), p2 (U, w, B)).
    """
    Bu, w, _, B = L.shape
    U = int(binv.shape[0])
    if blk & (blk - 1):
        raise ValueError(f"blk must be a power of two, got {blk}")
    dtype = L.dtype
    pair = pl.BlockSpec((None,), lambda u, i: (u,))   # this pair's scalar
    whole = pl.BlockSpec()                            # indexed in-kernel
    E, p1, p2 = pl.pallas_call(
        partial(_phi_kernel, w, B, blk),
        out_shape=(jax.ShapeDtypeStruct((U * w * w, B), dtype),
                   jax.ShapeDtypeStruct((U * w, B), dtype),
                   jax.ShapeDtypeStruct((U * w, B), dtype)),
        grid=(U, pl.cdiv(B, blk)),
        in_specs=[pair, pair, whole],
        out_specs=(whole, whole, whole),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps,
                                           num_stages=1),
        interpret=interpret,
        name="phi_tables",
    )(jnp.asarray(binv, jnp.int32), jnp.asarray(h_u, dtype),
      L.reshape(Bu * w * w, B))
    return (E.reshape(U, w, w, B), p1.reshape(U, w, B),
            p2.reshape(U, w, B))

