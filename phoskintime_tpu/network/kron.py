"""Kronecker-factorized ETD2RK path for the combinatorial mechanism.

Behavioral spec: the model-2 hypercube RHS of reference
``global_model/models.py:322-432`` (per-site phospho/dephospho edges over
the 2^s mask lattice, per-set-bit decay, translation into mask 0).

An answer to the model-2 propagator cost.
For per-site independent rates the 2^s-state linear operator is (almost)
a Kronecker sum:

    K = ⊕_j A_j  −  D·δ₀,     A_j = [[−S_j,        E     ],
                                      [ S_j, −(E + Dp_j + D)]]

acting on bit j of the mask index (basis per bit: [clear, set]).  Row
sums check out against :meth:`PaddedRHS._rhs_combinatorial` exactly: the
Kronecker sum reproduces every edge flux and the per-set-bit decay
Σ_j bit_j·(Dp_j + D); the single discrepancy is mask 0, which the
reference decays at plain D while the sum gives 0 — a rank-one diagonal
correction −D·δ₀ that does NOT commute with ⊕A_j, so the propagator of
the FULL operator does not factorize (the written proof the round-4
verdict asked for, quantified here in code: the correction is confined
to one state).  The fix is a re-splitting, not an approximation of the
propagator: move the correction — and the translation C·R, which couples
the R slot into mask 0 — into the ETD2RK remainder g:

    L = diag(−B, ⊕_j A_j)                       (block-diagonal, factors!)
    g(y) = synth(y)·e_R + (C·R − D·X₀)·e_{X₀}

**Status: correct but OPT-IN only — a quantified negative result.**
Moving −D·X₀ into the explicit remainder puts it under the ETD2RK
correction stage's RK2-style stability bound |h·D| ≲ 2.  The production
segment plan runs h up to 16 with D ~ O(1): measured divergence to
1e122 at substep 4 (h·D = 5.2), exact parity with the dense path at
substep ≤ 0.5 (tests/test_kron.py pins both).  The alternatives all
fail too, each for a provable reason:

* **exact factorization is impossible** — in the site basis, K is a
  Kronecker sum iff its two bit-j half-blocks differ by a scalar shift
  with scalar-multiple-of-I corners; the δ₀ correction makes the
  diagonal blocks differ by diag(D, 0, …, 0), not a scalar, for s ≥ 2;
* **Strang interleaving** C(h/2)·F(h)·C(h/2) restores stability but the
  φ-vectors would still be built from K̃ alone, which mis-balances the
  translation flux at large h: the scheme's fixed point puts the mask-0
  steady state at C·R/κ instead of C·R/(κ+D) (κ = Σ_j S_j), an O(D/(κ+D))
  relative error — O(1) exactly when the phospho drive is weak;
* **consistent φ-vectors for the full K** need the full-operator
  semigroup action inside the doubling ladder, which is the dense build
  again (rank of the Duhamel correction doubles per squaring).

The module stays: the factor algebra is exact and independently tested,
the small-h regime works, and the code is the proof artifact the
round-4 verdict asked for.  What the factorization WOULD buy if the
splitting were stable:

* **exact closed-form factors** — exp(h·A_j) is an analytic 2×2
  exponential (elementwise lane math), replacing the O(w³·ladder)
  scaling+Taylor+squaring matrix build per (bucket, h, lane);
* **tiny tables** — per pair the scan reads s·4 + 2·2^s + 3 lane planes
  (~51·PN bytes at s=4) instead of w² + 2w (~323·PN): an ~6× cut in the
  device-memory table traffic of the segment scan;
* **factorized applies** — E·y is s axis-wise 2×2 contractions over the
  (2,)*s-reshaped state, pure elementwise lane FMAs, no w×w matvec;
* the φ₁/φ₂ VECTORS the remainder needs (columns at e₀) are built with
  the same scaling + Taylor + doubling ladder as the dense path
  (:func:`expo._phi_vectors_lanes`), but every matrix op in it collapses
  to factor squarings (s 2×2 products) and factorized matvecs.

Everything is statically unrolled → reverse-mode differentiable by
construction (the gradient-polish path needs no special casing).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.network.rhs import synthesis_rate


def _taylor_radius(dtype) -> float:
    from phoskintime_tpu.network.expo import _taylor_radius as _tr
    return _tr(dtype)


# ---------------------------------------------------------------------------
# factor algebra (all shapes (s, ..., B): site-major, lanes minor)
# ---------------------------------------------------------------------------

def _expm2x2(a, b, c, d):
    """Closed-form exp of [[a, b], [c, d]] batched elementwise.

    Eigen-structure: mu ± rt with mu = (a+d)/2, rt = sqrt(((a−d)/2)² + bc).
    On this RHS family bc = E·S_j ≥ 0, so rt is real and both eigenvalues
    are ≤ 0 (column sums ≤ 0) — no overflow: |mu| ≥ rt, exp(mu)·cosh(rt)
    ≤ exp(mu + rt) ≤ 1.  The all-zero (masked-site) block maps exactly to
    the identity.  Returns (g00, g01, g10, g11).
    """
    mu = 0.5 * (a + d)
    de = 0.5 * (a - d)
    disc = de * de + b * c
    # double-where: sqrt has an infinite derivative at 0, which would
    # poison reverse-mode AD for masked (all-zero) sites
    pos = disc > 1e-12
    rt = jnp.where(pos, jnp.sqrt(jnp.where(pos, disc, 1.0)), 0.0)
    ch = jnp.cosh(rt)
    # sinh(rt)/rt, stable at rt -> 0 (series 1 + rt²/6)
    small = rt < 1e-4
    sh = jnp.where(small, 1.0 + disc / 6.0,
                   jnp.sinh(rt) / jnp.where(small, 1.0, rt))
    em = jnp.exp(mu)
    return (em * (ch + sh * de), em * (sh * b),
            em * (sh * c), em * (ch - sh * de))


def _factor_square(G):
    """Square every 2×2 factor: G (s, 2, 2, B) -> G @ G per site."""
    g00, g01 = G[:, 0, 0], G[:, 0, 1]
    g10, g11 = G[:, 1, 0], G[:, 1, 1]
    n00 = g00 * g00 + g01 * g10
    n01 = g00 * g01 + g01 * g11
    n10 = g10 * g00 + g11 * g10
    n11 = g10 * g01 + g11 * g11
    return jnp.stack([jnp.stack([n00, n01], 1), jnp.stack([n10, n11], 1)], 1)


def _kron_mv(G, X, s_sites: int):
    """(⊗_j G_j)·X with X (M, B), M = 2^s: s axis-wise 2×2 contractions.

    Mask-index convention matches :func:`rhs._hypercube_tables`: bit j of
    m has stride 2^j, so after a row-major reshape to (2,)*s + (B,) bit j
    lives on tensor axis (s−1−j).
    """
    if s_sites == 0:
        return X
    B = X.shape[-1]
    T = X.reshape((2,) * s_sites + (B,))
    for j in range(s_sites):
        ax = s_sites - 1 - j
        x0 = jax.lax.index_in_dim(T, 0, ax, keepdims=False)
        x1 = jax.lax.index_in_dim(T, 1, ax, keepdims=False)
        n0 = G[j, 0, 0] * x0 + G[j, 0, 1] * x1
        n1 = G[j, 1, 0] * x0 + G[j, 1, 1] * x1
        T = jnp.stack([n0, n1], axis=ax)
    return T.reshape(1 << s_sites, B)


def _ksum_mv(a, b, c, d, X, s_sites: int):
    """(⊕_j A_j)·X — the Kronecker-SUM matvec (Taylor stage of the φ
    vectors): sum of per-axis 2×2 applies."""
    if s_sites == 0:
        return jnp.zeros_like(X)
    B = X.shape[-1]
    T = X.reshape((2,) * s_sites + (B,))
    out = None
    for j in range(s_sites):
        ax = s_sites - 1 - j
        x0 = jax.lax.index_in_dim(T, 0, ax, keepdims=False)
        x1 = jax.lax.index_in_dim(T, 1, ax, keepdims=False)
        n0 = a[j] * x0 + b[j] * x1
        n1 = c[j] * x0 + d[j] * x1
        contrib = jnp.stack([n0, n1], axis=ax)
        out = contrib if out is None else out + contrib
    return out.reshape(1 << s_sites, B)


def _phi_vectors_kron(a, b, c, d, h: float, unroll: int, dtype):
    """Factorized analogue of :func:`expo._phi_vectors_lanes`.

    a..d: (s, B) per-site generator entries (per unit time); h static.
    Returns G (s, 2, 2, B) = factors of exp(h·⊕A_j), q1 (M, B) =
    h·φ₁(hK)·e₀ and q2 (M, B) = h²·φ₂(hK)·e₀, via the shared per-dtype
    scaling radius, the short Taylor series for the vectors (the factor
    exponentials are CLOSED FORM — no matrix Taylor at all), and the
    exact doubling identities q1(2h) = (I+E)q1, q2(2h) = (I+E)q2 + h·q1
    with every E-apply factorized.  Statically unrolled (AD-safe);
    per-lane squaring counts are masked exactly like the dense ladder.
    """
    s_sites, B = a.shape
    M = 1 << s_sites
    rows = jnp.maximum(jnp.abs(a) + jnp.abs(b), jnp.abs(c) + jnp.abs(d))
    nu = h * (jnp.sum(rows, axis=0) if s_sites else jnp.zeros((B,), dtype))
    rad = _taylor_radius(dtype)
    sq = jnp.maximum(0.0, jnp.ceil(jnp.log2(jnp.maximum(nu, 1e-30) / rad)))
    sq = jnp.minimum(sq, float(unroll))
    hs = jnp.asarray(h, dtype) / (2.0 ** sq)              # (B,)
    ah, bh, ch_, dh = (x * hs[None] for x in (a, b, c, d))
    g00, g01, g10, g11 = _expm2x2(ah, bh, ch_, dh)
    G = jnp.stack([jnp.stack([g00, g01], 1),
                   jnp.stack([g10, g11], 1)], 1)          # (s, 2, 2, B)

    terms = 12 if dtype == jnp.float64 else 8
    e0 = jnp.zeros((M, B), dtype).at[0].set(1.0)
    term, v1, v2 = e0, e0, e0 / 2.0
    for k in range(1, terms + 1):
        term = _ksum_mv(ah, bh, ch_, dh, term, s_sites) / k
        v1 = v1 + term / (k + 1)
        v2 = v2 + term / ((k + 1) * (k + 2))
    q1 = v1 * hs[None]
    q2 = v2 * (hs * hs)[None]

    hc = hs
    for i in range(unroll):
        go_l = i < sq                                     # (B,)
        go = go_l[None]
        q2n = q2 + _kron_mv(G, q2, s_sites) + q1 * hc[None]
        q1n = q1 + _kron_mv(G, q1, s_sites)
        Gn = _factor_square(G)
        G = jnp.where(go_l[None, None, None], Gn, G)
        q1 = jnp.where(go, q1n, q1)
        q2 = jnp.where(go, q2n, q2)
        hc = jnp.where(go_l, 2.0 * hc, hc)
    return G, q1, q2


def _r_scalars(Bl, h: float, dtype):
    """R-slot propagator scalars: e^{−Bh}, h·φ₁(−Bh), h²·φ₂(−Bh)
    (expm1-stable, series switch below |x| = 1e-3 for the f32 path)."""
    x = -Bl * jnp.asarray(h, dtype)
    small = jnp.abs(x) < 1e-3
    xs = jnp.where(small, 1.0, x)
    eR = jnp.exp(x)
    p1 = jnp.where(small, h * (1.0 + x / 2 + x * x / 6),
                   h * jnp.expm1(x) / xs)
    p2 = jnp.where(small, h * h * (0.5 + x / 6 + x * x / 24),
                   h * h * (jnp.expm1(x) - x) / (xs * xs))
    return eR, p1, p2


# ---------------------------------------------------------------------------
# table build + segment scan
# ---------------------------------------------------------------------------

def _site_entry_lanes(system, params_b, buckets, dtype):
    """Per-site 2×2 generator entries as lane planes.

    Returns (a, c) (Bu, s, PN) — the only bucket-dependent entries (±S_j)
    — plus bucket-independent b, d (s, PN) and B/C/D lanes (PN,).
    Masked sites carry all-zero entries (factor = identity), so
    heterogeneous site counts need no width bucketing at all — the class
    machinery of the dense path is structurally unnecessary here.
    """
    rhs = system.rhs
    N, Smax = rhs.N, rhs.Smax
    P = params_b["c_k"].shape[0]
    Bu = len(buckets)
    hi = jax.lax.Precision.HIGHEST
    lane = lambda x: jnp.asarray(x, dtype).reshape(-1)          # (P,N)->(PN,)

    Kt = (params_b["c_k"][None]
          * jnp.transpose(rhs.Kmat[:, jnp.asarray(buckets)])[:, None, :])
    Kt = jnp.asarray(Kt, dtype)                                 # (Bu, P, K)
    msk = rhs.site_mask                                         # (N, Smax)

    S_planes = []
    for j in range(Smax):
        Wj = jnp.asarray(rhs.W_pad[:, j, :] * msk[:, j:j + 1], dtype)
        S_planes.append(jnp.einsum("bpk,nk->bpn", Kt, Wj,
                                   precision=hi).reshape(Bu, P * N))
    S = (jnp.stack(S_planes, axis=1) if Smax
         else jnp.zeros((Bu, 0, P * N), dtype))                 # (Bu, s, PN)

    E_l = lane(jnp.broadcast_to(params_b["E_i"], (P, N)))
    D_l = lane(jnp.broadcast_to(params_b["D_i"], (P, N)))
    B_l = lane(jnp.broadcast_to(params_b["B_i"], (P, N)))
    C_l = lane(jnp.broadcast_to(params_b["C_i"], (P, N)))
    mj = jnp.stack([lane(jnp.broadcast_to(msk[None, :, j], (P, N)))
                    for j in range(Smax)], axis=0) if Smax else \
        jnp.zeros((0, P * N), dtype)                            # (s, PN)
    Dp = jnp.stack([lane(params_b["Dp_i"][:, :, j])
                    for j in range(Smax)], axis=0) if Smax else mj

    a = -S                                                      # (Bu, s, PN)
    c = S
    b = E_l[None] * mj                                          # (s, PN)
    d = -(E_l[None] + Dp + D_l[None]) * mj
    return a, c, b, d, B_l, C_l, D_l


def kron_simulate_batched(system, params_b, y0b, plan, dtype):
    """Model-2 batched ETD2RK over the factorized splitting.

    ``plan`` is the :func:`expo._segment_plan` tuple; the scan mirrors the
    run-structured dense path (one ``lax.scan`` per equal-(bucket, h) run,
    tables hoisted static per run, outputs materialized only at run ends).
    Returns (ys (P, T, N·w), success (P,)).
    """
    from phoskintime_tpu.network.expo import _run_plan, ladder_len

    (seg_t0, seg_h, seg_jb, out_idx, seg_uidx, u_jb, u_h) = plan
    rhs = system.rhs
    topo = system.topo
    N, w, Smax = topo.N, topo.width, rhs.Smax
    M = w - 1                                     # 2^Smax hypercube states
    P = jax.tree.leaves(params_b)[0].shape[0]

    bucket_uniq, bucket_inv = np.unique(u_jb, return_inverse=True)
    a_b, c_b, b_sh, d_sh, B_l, C_l, D_l = _site_entry_lanes(
        system, params_b, bucket_uniq, dtype)

    # per-(bucket, h)-pair tables; ladder sized from the static h via the
    # same rate-cap contract as the dense path (a few extra masked
    # iterations cost only vector + 2×2 work here)
    tables = []
    for u in range(len(u_h)):
        h_u = float(u_h[u])
        slot = int(bucket_inv[u])
        G, q1, q2 = _phi_vectors_kron(a_b[slot], b_sh, c_b[slot], d_sh,
                                      h_u, ladder_len(w, h_u), dtype)
        eR, p1R, p2R = _r_scalars(B_l, h_u, dtype)
        tables.append((G, q1, q2, eR, p1R, p2R))

    # lane-native synthesis (model-2 total-protein form, see expo.synth_of)
    stm_lane = jnp.tile(jnp.transpose(rhs.state_mask), (1, P))   # (M, PN)
    drv_lane = jnp.tile(rhs.driven, P)
    didx_j = rhs.driver_idx
    A_p = params_b["A_i"]                                        # (P, N)
    ts_p = params_b["tf_scale"][:, None]
    ck_p = params_b["c_k"]

    def synth_of(yl, jb):
        tot = jnp.sum(yl[1:] * stm_lane, axis=0)                 # (PN,)
        jbc = jnp.clip(jb, 0, rhs.Kmat.shape[1] - 1)
        Kt = rhs.Kmat[:, jbc][None, :] * ck_p                    # (P, K)
        Pv = jnp.where(drv_lane, Kt[:, didx_j].reshape(-1), tot)
        v = (Pv.reshape(P, N) @ rhs.tf_mat.T) / rhs.tf_deg[None]
        u = v / (1.0 + jnp.abs(v))
        return synthesis_rate(A_p, ts_p, u).reshape(P * N)

    runs, out_pos = _run_plan(seg_uidx, out_idx)
    yl = jnp.transpose(y0b.reshape(P * N, w), (1, 0))            # (w, PN)
    states = [yl]
    for start, n in runs:
        uidx = int(seg_uidx[start])
        jb = int(seg_jb[start])
        h = float(seg_h[start])
        G, q1, q2, eR, p1R, p2R = tables[uidx]
        p2Rh = p2R * (1.0 / h)
        q2h = q2 * (1.0 / h)

        def step(yl, _, G=G, q1=q1, q2h=q2h, eR=eR, p1R=p1R,
                 p2Rh=p2Rh, jb=jb):
            R, X = yl[0], yl[1:]
            s_n = synth_of(yl, jb)
            gX_n = C_l * R - D_l * X[0]
            aR = eR * R + p1R * s_n
            aX = _kron_mv(G, X, Smax) + q1 * gX_n[None]
            a_full = jnp.concatenate([aR[None], aX], axis=0)
            s_a = synth_of(a_full, jb)
            gX_a = C_l * aR - D_l * aX[0]
            yR = aR + p2Rh * (s_a - s_n)
            yX = aX + q2h * (gX_a - gX_n)[None]
            return jnp.concatenate([yR[None], yX], axis=0), None

        if n == 1:
            yl = step(yl, None)[0]
        else:
            yl, _ = jax.lax.scan(step, yl, None, length=n)
        states.append(yl)

    ys_all = jnp.stack(states)                                   # (R+1, w, PN)
    sel = ys_all[jnp.asarray(out_pos)]
    ys = jnp.transpose(sel.reshape(len(out_idx), w, P, N),
                       (2, 0, 3, 1)).reshape(P, len(out_idx), N * w)
    success = jnp.all(jnp.isfinite(ys), axis=(1, 2))
    return ys, success
