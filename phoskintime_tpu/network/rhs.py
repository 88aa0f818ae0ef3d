"""Vectorized RHS kernels for the global network model.

Behavioral spec: reference ``global_model/models.py`` (four mechanisms —
distributive 0, sequential 1, combinatorial 2, saturating 4 — plus the
rational soft-clipped synthesis rate) and ``global_model/jacspeedup.py``
(CSR matvecs, step-interpolated kinase input, driver overrides).

Accelerator-native design: the per-protein Numba loops become dense masked
array ops over the padded (N, width) state:

* ``S = einsum('nsk,k->ns', W_pad, Kt)`` replaces the CSR W matvec (these
  networks are small enough that a dense matmul beats sparse gathers by a
  wide margin);
* the TF coupling is one (N, N) matvec;
* the combinatorial hypercube runs as gathers along a static XOR index
  table + masked einsums over (N, Smax, Mmax) — all 2^n transitions of all
  proteins at once;
* everything is shape-static and differentiable, so ``jax.jacfwd`` provides
  the analytic Jacobian the reference approximates by finite differences
  (``jacspeedup.py:397-588``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


def synthesis_rate(A, tf_scale, u_squashed):
    """Rational Hill-like synthesis rate (reference models.py:27-65).

    ``u_squashed`` is already in (-1, 1) (the caller applies u/(1+|u|)).
    Activation: A * (1 + tf_scale*u / (1 + u + 1e-6));
    repression: A / (1 + tf_scale*|u|).
    """
    act = A * (1.0 + (tf_scale * u_squashed) / (1.0 + u_squashed + 1e-6))
    rep = A / (1.0 + tf_scale * jnp.abs(u_squashed))
    return jnp.where(u_squashed >= 0.0, act, rep)


def tf_inputs(tf_mat, tf_deg, P_vec):
    """Squashed TF drive u in (-1, 1) (reference network.py:379-383)."""
    v = (tf_mat @ P_vec) / tf_deg
    return v / (1.0 + jnp.abs(v))


@lru_cache(maxsize=None)
def _linear_block_tables(model: int, w: int):
    """Constant one-hot (slot, w, w) placement tables for the analytic
    linear blocks: the per-protein coefficient vectors contract against
    these with ONE (N, slots) @ (slots, w*w) matmul — no scatters."""
    smax = w - 2
    scalars = np.zeros((5, w, w))        # [-B, C, P0-diag, E->P0 unused, ...]
    scalars[0, 0, 0] = 1.0               # dR/dR coefficient slot
    scalars[1, 1, 0] = 1.0               # dP0/dR
    scalars[2, 1, 1] = 1.0               # dP0/dP0
    scalars[3, 1, 2] = 1.0 if w > 2 else 0.0   # dP0/ds_1 (model 1)
    T_1s = np.zeros((smax, w, w))        # dP0/ds_j (model 0)
    T_s1 = np.zeros((smax, w, w))        # ds_j/dP0
    T_diag = np.zeros((smax, w, w))      # ds_j/ds_j
    T_sub = np.zeros((smax, w, w))       # ds_j/ds_{j-1} (model 1, j>=1)
    T_sup = np.zeros((smax, w, w))       # ds_j/ds_{j+1}
    for j in range(smax):
        T_1s[j, 1, 2 + j] = 1.0
        T_s1[j, 2 + j, 1] = 1.0
        T_diag[j, 2 + j, 2 + j] = 1.0
        if j >= 1:
            T_sub[j, 2 + j, 1 + j] = 1.0
        if j + 1 < smax:
            T_sup[j, 2 + j, 3 + j] = 1.0
    return tuple(np.reshape(t, (-1, w * w))
                 for t in (scalars, T_1s, T_s1, T_diag, T_sub, T_sup))


@lru_cache(maxsize=None)
def _hypercube_tables(smax: int):
    """Static bitmask tables for the combinatorial mechanism.

    bits[j, m]   : bit j of state m (float 0/1)
    xor_idx[j, m]: m XOR (1 << j)
    """
    mmax = 1 << smax
    m = np.arange(mmax, dtype=np.int64)[None, :]
    j = np.arange(smax, dtype=np.int64)[:, None]
    bits = ((m >> j) & 1).astype(np.float64)
    xor_idx = (m ^ (1 << j)).astype(np.int32)
    return bits, xor_idx


class PaddedRHS:
    """RHS over the padded state, closed over static topology arrays.

    Call signature matches the integrator's bucketed contract:
    ``rhs(t, y_flat, jb) -> dy_flat`` where jb indexes the kinase grid.
    """

    def __init__(self, topo, Kmat, dtype=jnp.float64):
        self.model = int(topo.model)
        self.N = topo.N
        self.Smax = topo.max_sites
        self.width = topo.width
        self.W_pad = jnp.asarray(topo.W_pad, dtype)
        self.tf_mat = jnp.asarray(topo.tf_mat, dtype)
        self.tf_deg = jnp.asarray(topo.tf_deg, dtype)
        self.driver_map = jnp.asarray(topo.driver_map)
        self.driven = self.driver_map >= 0
        self.driver_idx = jnp.maximum(self.driver_map, 0)
        self.site_mask = jnp.asarray(topo.site_mask(), dtype)
        self.Kmat = jnp.asarray(Kmat, dtype)  # (K, n_buckets)
        if self.model == 2:
            bits, xor_idx = _hypercube_tables(self.Smax)
            self.bits = jnp.asarray(bits, dtype)          # (Smax, Mmax)
            self.xor_idx = jnp.asarray(xor_idx)           # (Smax, Mmax)
            self.state_mask = jnp.asarray(topo.state_mask(), dtype)  # (N, Mmax)
            self.Mmax = topo.max_states

    # -- shared pieces ----------------------------------------------------
    def kinase_activity(self, params, jb):
        """Kt = K(t) * c_k, clamped bucket index (reference network.py:189-196)."""
        jb = jnp.clip(jb, 0, self.Kmat.shape[1] - 1)
        return self.Kmat[:, jb] * params["c_k"]

    def site_rates(self, Kt):
        """S (N, Smax): per-site phospho drive = W . Kt."""
        return jnp.einsum("nsk,k->ns", self.W_pad, Kt,
                          precision=jax.lax.Precision.HIGHEST)

    def total_protein(self, Y):
        if self.model == 2:
            return jnp.sum(Y[:, 1:] * self.state_mask, axis=1)
        sites = Y[:, 2:] * self.site_mask
        return Y[:, 1] + jnp.sum(sites, axis=1)

    def p_vec(self, Y, Kt):
        """Observable protein vector with kinase live-drive override
        (reference network.py:350-376, jacspeedup driver_map)."""
        tot = self.total_protein(Y)
        return jnp.where(self.driven, Kt[self.driver_idx], tot)

    # -- main entry -------------------------------------------------------
    def __call__(self, t, y_flat, jb, params, u_override=None):
        """RHS evaluation; ``u_override`` freezes the TF input (used by the
        exponential integrator to expose the block-diagonal linear part —
        with u constant, no cross-protein coupling remains)."""
        Y = y_flat.reshape(self.N, self.width)
        Kt = self.kinase_activity(params, jb)
        S = self.site_rates(Kt)
        if u_override is None:
            P_vec = self.p_vec(Y, Kt)
            u = tf_inputs(self.tf_mat, self.tf_deg, P_vec)
        else:
            u = u_override
        synth = synthesis_rate(params["A_i"], params["tf_scale"], u)

        if self.model == 2:
            dY = self._rhs_combinatorial(Y, S, synth, params)
        elif self.model == 1:
            dY = self._rhs_sequential(Y, S, synth, params)
        elif self.model == 4:
            dY = self._rhs_saturating(Y, S, synth, params)
        else:
            dY = self._rhs_distributive(Y, S, synth, params)
        return dY.reshape(-1)

    # -- mechanisms -------------------------------------------------------
    def _rhs_distributive(self, Y, S, synth, p):
        """Model 0 (reference models.py:149-212)."""
        A, B, C, D, E = p["A_i"], p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]  # (N, Smax)
        msk = self.site_mask
        R, P0, sites = Y[:, 0], Y[:, 1], Y[:, 2:] * msk
        Sm = S * msk

        dR = synth - B * R
        d_sites = (Sm * P0[:, None]
                   - (E[:, None] + Dp + D[:, None]) * sites) * msk
        sum_S = jnp.sum(Sm, axis=1)
        sum_back = E * jnp.sum(sites, axis=1)
        dP0 = C * R - (D + sum_S) * P0 + sum_back
        return jnp.concatenate([dR[:, None], dP0[:, None], d_sites], axis=1)

    def _rhs_saturating(self, Y, S, synth, p):
        """Model 4 Michaelis-Menten (reference models.py:71-146)."""
        A, B, C, D, E = p["A_i"], p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]
        msk = self.site_mask
        R, P0, sites = Y[:, 0], Y[:, 1], Y[:, 2:] * msk
        Sm = S * msk

        dR = synth - B * R
        trans = (C * R) / (1.0 + R)
        fflux = (Sm * P0[:, None]) / (1.0 + P0[:, None])
        back = E[:, None] * sites
        d_sites = (fflux - (Dp + D[:, None]) * sites - back) * msk
        dP0 = trans - D * P0 - jnp.sum(fflux * msk, axis=1) + jnp.sum(back * msk, axis=1)
        return jnp.concatenate([dR[:, None], dP0[:, None], d_sites], axis=1)

    def synthesis_vector(self, Y, Kt, params):
        """(N,) synthesis drive — the ONLY non-linear-in-y RHS term of the
        affine mechanisms (models 0/1/2): every other term is L y with L
        the frozen-bucket block operator, so the exponential integrator's
        remainder g(y) = rhs(y) - L y is exactly this vector scattered
        into the R slot. Computing it directly skips the full RHS + the
        L-matvec subtraction in the hot segment scan."""
        P_vec = self.p_vec(Y, Kt)
        u = tf_inputs(self.tf_mat, self.tf_deg, P_vec)
        return synthesis_rate(params["A_i"], params["tf_scale"], u)

    def linear_blocks(self, S, p):
        """Analytic (N, w, w) block-diagonal linear operators for the
        affine mechanisms (TF input frozen): model 0 distributive and
        model 1 sequential. Exact (the RHS is linear in the state), and
        ~15x cheaper than recovering the blocks with w jvp passes.
        Returns None for mechanisms without a closed form (model 2 falls
        back to jvp extraction)."""
        if self.model not in (0, 1):
            return None
        N, w = self.N, self.width
        msk = self.site_mask
        B, C, D, E = p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]
        Sm = S * msk
        dt_ = Sm.dtype
        t_sc, t_1s, t_s1, t_diag, t_sub, t_sup = (
            jnp.asarray(t, dt_) for t in _linear_block_tables(self.model, w))

        # NOTE: placement contractions pinned to HIGHEST precision — a
        # reduced-precision default (bf16 passes, or TF32 on a GPU)
        # corrupts the linear operators (hence the propagators) at ~1e-3
        # relative.
        dot = lambda a, t: jnp.dot(a, t, precision=jax.lax.Precision.HIGHEST)
        if self.model == 0:
            # dP0 = C R - (D + sum S) P0 + E sum(sites)
            # ds_j = S_j P0 - (E + Dp_j + D) s_j
            sc = jnp.stack([-B, C, -D - jnp.sum(Sm, axis=1),
                            jnp.zeros_like(B), jnp.zeros_like(B)], axis=1)
            flat = (dot(sc, t_sc)
                    + dot(E[:, None] * msk, t_1s)
                    + dot(Sm, t_s1)
                    + dot(-(E[:, None] + Dp + D[:, None]) * msk, t_diag))
        else:
            # chain: dP0 = C R - D P0 - k0 P0 + E P1 (if any sites)
            # ds_j = k_j prev_j + E nxt_j - (k_{j+1} + E + Dp_j + D) s_j
            has_sites = msk[:, 0]
            has_next = jnp.concatenate(
                [msk[:, 1:], jnp.zeros_like(msk[:, :1])], axis=1)
            k_next = jnp.concatenate(
                [Sm[:, 1:], jnp.zeros_like(Sm[:, :1])], axis=1)
            sc = jnp.stack([-B, C, -D - Sm[:, 0] * has_sites,
                            E * has_sites, jnp.zeros_like(B)], axis=1)
            sub_vals = jnp.concatenate(
                [jnp.zeros_like(Sm[:, :1]), Sm[:, 1:] * msk[:, 1:]], axis=1)
            flat = (dot(sc, t_sc)
                    + dot(Sm[:, :1] * msk[:, :1], t_s1[:1])
                    + dot(sub_vals, t_sub)
                    + dot(E[:, None] * has_next * msk, t_sup)
                    + dot(-(k_next * has_next + E[:, None] + Dp + D[:, None])
                          * msk, t_diag))
        return flat.reshape(N, w, w)

    def jac_blocks_saturating(self, Y, S, p):
        """Analytic (N, w, w) block Jacobian of the saturating mechanism
        (TF input frozen). Used by the exponential-Rosenbrock integrator:
        closed-form is ~6x cheaper than w jvp passes per segment.

        Nonzero entries (slots [R, P0, s_1..s_Smax]):
          dR/dR        = -B
          dP0/dR       = C/(1+R)^2
          dP0/dP0      = -D - sum_j S_j m_j /(1+P0)^2
          dP0/ds_j     = +E m_j
          ds_j/dP0     = S_j m_j /(1+P0)^2
          ds_j/ds_j    = -(Dp_j + D + E) m_j
        """
        N, w = self.N, self.width
        msk = self.site_mask
        B, C, D, E = p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]
        R, P0 = Y[:, 0], Y[:, 1]
        Sm = S * msk
        dtrans = C / (1.0 + R) ** 2
        dflux = Sm / (1.0 + P0[:, None]) ** 2          # (N, Smax)

        # same placement tables as the affine blocks (this runs INSIDE the
        # Rosenbrock segment scan, so scatters here would be per-step);
        # HIGHEST precision, see linear_blocks
        t_sc, t_1s, t_s1, t_diag, *_ = (
            jnp.asarray(t, Sm.dtype) for t in _linear_block_tables(0, w))
        dot = lambda a, t: jnp.dot(a, t, precision=jax.lax.Precision.HIGHEST)
        sc = jnp.stack([-B, dtrans, -D - jnp.sum(dflux, axis=1),
                        jnp.zeros_like(B), jnp.zeros_like(B)], axis=1)
        flat = (dot(sc, t_sc)
                + dot(E[:, None] * msk, t_1s)
                + dot(dflux, t_s1)
                + dot(-(Dp + D[:, None] + E[:, None]) * msk, t_diag))
        return flat.reshape(N, w, w)

    def _rhs_sequential(self, Y, S, synth, p):
        """Model 1 chain (reference models.py:215-306)."""
        A, B, C, D, E = p["A_i"], p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]
        msk = self.site_mask                       # (N, Smax)
        R, P0 = Y[:, 0], Y[:, 1]
        sites = Y[:, 2:] * msk
        Sm = S * msk
        has_sites = msk[:, 0]                      # (N,) float 1 if ns > 0

        dR = synth - B * R

        # previous species in the chain: P0 for slot 0, site j-1 otherwise
        prev = jnp.concatenate([P0[:, None], sites[:, :-1]], axis=1)
        # next-site forward rate exists iff slot j+1 is valid
        k_next = jnp.concatenate([Sm[:, 1:], jnp.zeros_like(Sm[:, :1])], axis=1)
        has_next = jnp.concatenate([msk[:, 1:], jnp.zeros_like(msk[:, :1])], axis=1)
        nxt = jnp.concatenate([sites[:, 1:], jnp.zeros_like(sites[:, :1])], axis=1)

        d_sites = (Sm * prev
                   + E[:, None] * nxt * has_next
                   - (k_next * has_next + E[:, None] + Dp + D[:, None]) * sites) * msk

        k0 = Sm[:, 0]
        P1 = sites[:, 0]
        dP0 = C * R - D * P0 - k0 * P0 * has_sites + E * P1 * has_sites
        return jnp.concatenate([dR[:, None], dP0[:, None], d_sites], axis=1)

    def _rhs_combinatorial(self, Y, S, synth, p):
        """Model 2 hypercube (reference models.py:322-432).

        Per set bit of each mask: dephospho edge at rate E plus decay
        (Dp_j + D); per clear bit: phospho edge at rate S_j. Translation
        feeds mask 0, which also carries plain decay D.
        """
        A, B, C, D, E = p["A_i"], p["B_i"], p["C_i"], p["D_i"], p["E_i"]
        Dp = p["Dp_i"]                              # (N, Smax)
        R = Y[:, 0]
        X = Y[:, 1:] * self.state_mask              # (N, Mmax)
        smask = self.site_mask                      # (N, Smax)
        Sm = S * smask

        dR = synth - B * R

        # neighbor states across each bit: X_x[n, j, m] = X[n, m ^ (1<<j)]
        X_x = X[:, self.xor_idx]                    # (N, Smax, Mmax)
        bits = self.bits                            # (Smax, Mmax)
        # edge fluxes per (site, state):
        #   bit set  : in S_j*X[m^b] (phospho up), out E*X[m] (dephospho)
        #   bit clear: in E*X[m^b] (dephospho down), out S_j*X[m] (phospho)
        inflow = (bits[None] * Sm[:, :, None] * X_x
                  + (1 - bits[None]) * E[:, None, None] * X_x)
        outflow = (bits[None] * E[:, None, None] * X[:, None, :]
                   + (1 - bits[None]) * Sm[:, :, None] * X[:, None, :])
        valid = smask[:, :, None]                   # site exists
        dX = jnp.sum((inflow - outflow) * valid, axis=1)

        # per-set-bit decay (Dp_j + D per bit); mask 0 decays at plain D
        decay_rate = jnp.einsum("nj,jm->nm", (Dp + D[:, None]) * smask, bits,
                                precision=jax.lax.Precision.HIGHEST)
        decay_rate = decay_rate.at[:, 0].set(D)
        dX = dX - decay_rate * X
        dX = dX.at[:, 0].add(C * R)                 # translation into mask 0
        dX = dX * self.state_mask
        return jnp.concatenate([dR[:, None], dX], axis=1)
