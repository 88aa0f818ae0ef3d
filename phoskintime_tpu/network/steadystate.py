"""Initial conditions and analytic steady states for the global model.

Spec: reference ``global_model/steadystate.py`` —
1. data-driven y0 (mass-balance: P_tot from data, phospho mass capped at
   <= 30% of P_tot, P0 by conservation; RNA = first observed value);
2. analytic params=1 steady states per mechanism (distributive closed form,
   sequential tridiagonal, combinatorial dense linear solve) used as
   structural validation oracles.

Accelerator-native: the sequential case runs the batched Thomas solver over all
proteins at once; the combinatorial case solves a batch of (Mmax, Mmax)
systems with one ``jnp.linalg.solve``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from phoskintime_tpu.network.rhs import _hypercube_tables
from phoskintime_tpu.ops.tridiag import thomas_solve_batched


def _squash(u):
    return u / (1.0 + np.abs(u))


# ---------------------------------------------------------------------------
# data-driven y0
# ---------------------------------------------------------------------------

def _dict_at_time(df, key_cols, t0, value_col="fc", time_col="time", tol=1e-8):
    """{entity -> value} at time t0 (averaging replicates)."""
    import pandas as pd

    if df is None or len(df) == 0:
        return {}
    d = df.copy()
    d[time_col] = pd.to_numeric(d[time_col], errors="coerce")
    d[value_col] = pd.to_numeric(d[value_col], errors="coerce")
    d = d.dropna(subset=[time_col, value_col])
    m = np.isclose(d[time_col].to_numpy(float), float(t0), atol=tol, rtol=0.0)
    d = d.loc[m, key_cols + [value_col]]
    if len(d) == 0:
        return {}
    g = d.groupby(key_cols, as_index=False)[value_col].mean()
    if len(key_cols) == 1:
        return dict(zip(g[key_cols[0]].astype(str), g[value_col].astype(float)))
    return {tuple(r[key_cols].astype(str)): float(r[value_col])
            for _, r in g.iterrows()}


def build_y0_from_data(topo, df_prot, df_rna, df_pho, *, t_init=0.0,
                       t0_pho=0.0, eps=1e-9, max_pho_frac=0.3) -> np.ndarray:
    """Padded (N, width) y0 from experimental data
    (reference steadystate.py:209-328)."""
    import pandas as pd

    prot_init = _dict_at_time(df_prot, ["protein"], t_init)

    rna_init = {}
    if df_rna is not None and len(df_rna):
        d = df_rna.copy()
        d["time"] = pd.to_numeric(d["time"], errors="coerce")
        d["fc"] = pd.to_numeric(d["fc"], errors="coerce")
        d = d.dropna(subset=["time", "fc"])
        d0 = d.sort_values("time").groupby("protein", as_index=False).first()
        rna_init = dict(zip(d0["protein"], d0["fc"]))

    pho_init = _dict_at_time(df_pho, ["protein", "psite"], t0_pho)

    Y = np.zeros((topo.N, topo.width))
    for i, gene in enumerate(topo.proteins):
        R0 = max(float(rna_init.get(gene, 1.0)), eps)
        P_tot = max(float(prot_init.get(gene, 1.0)), eps)
        Y[i, 0] = R0

        sites = topo.sites[i]
        raw = np.asarray([float(pho_init.get((gene, s), 0.0)) for s in sites])
        if raw.sum() > 0:
            scale = min(max_pho_frac, max_pho_frac / raw.sum())
            site_mass = np.maximum(raw * scale * P_tot, 0.0)
        else:
            site_mass = np.zeros_like(raw)
        pho_sum = site_mass.sum()

        if topo.model == 2:
            Y[i, 1] = max(P_tot - pho_sum, eps)  # mask 0
            for j, mass in enumerate(site_mass):
                if mass > 0:
                    Y[i, 1 + (1 << j)] = max(mass, eps)
        else:
            Y[i, 1] = max(P_tot - pho_sum, eps)
            for j, mass in enumerate(site_mass):
                Y[i, 2 + j] = max(mass, eps)
    return Y


# ---------------------------------------------------------------------------
# analytic params=1 steady states
# ---------------------------------------------------------------------------

def steady_state_distributive(topo, TF_inputs=None, tf_scale=1.0) -> np.ndarray:
    """Closed form (reference steadystate.py:401-487), padded layout.

    With all rates 1: R = synth, P_j = S_j P / (E + Dp_j + D),
    P = C R / (D + sum_j S_j - sum_j E S_j/(E + Dp_j + D)).

    NOTE: the reference's analytic formulas omit the ``+ D`` protein-decay
    term that its own RHS applies to each phospho state
    (``models.py:203-209`` vs ``steadystate.py:455-473``) — its "steady
    state" is therefore not an equilibrium of its RHS. We use the corrected
    denominators so dy(y*) = 0 holds exactly.
    """
    N, Smax = topo.N, topo.max_sites
    u = _squash(np.zeros(N) if TF_inputs is None else np.asarray(TF_inputs, float))
    # the reference's analytic SS uses the *linear* activation
    # A*(1+tf_scale*u) rather than the RHS's rational form; at TF_inputs=0
    # (the structural-validation case) they coincide (synth = A = 1)
    synth = np.where(u >= 0, 1.0 + tf_scale * u, 1.0 / (1.0 + tf_scale * np.abs(u)))
    R = np.maximum(synth, 0.0)
    msk = topo.site_mask().astype(float)
    ns = topo.n_sites.astype(float)
    # E = Dp = S = D = 1 -> site decay E+Dp+D = 3, sum_frac = ns/3,
    # denom = D + ns - ns/3
    denom = np.maximum(1.0 + ns - ns / 3.0, np.finfo(float).tiny)
    P = np.where(ns > 0, R / denom, R)
    sites = (P[:, None] / 3.0) * msk

    Y = np.zeros((N, topo.width))
    Y[:, 0] = R
    Y[:, 1] = np.maximum(P, 0.0)
    Y[:, 2:] = np.maximum(sites, 0.0)
    return Y


def steady_state_sequential(topo, TF_inputs=None, tf_scale=1.0) -> np.ndarray:
    """Tridiagonal chain solve, batched over proteins
    (reference steadystate.py:494-596; ``+ D`` decay terms corrected to
    match the RHS — see the distributive docstring note)."""
    N, Smax = topo.N, topo.max_sites
    u = _squash(np.zeros(N) if TF_inputs is None else np.asarray(TF_inputs, float))
    synth = np.where(u >= 0, 1.0 + tf_scale * u, 1.0 / (1.0 + tf_scale * np.abs(u)))
    synth = np.maximum(synth, 0.0)
    R = synth

    n = Smax + 1  # chain [P0, P1..Pns] padded
    msk = topo.site_mask().astype(float)           # (N, Smax)
    ns_arr = topo.n_sites

    # assemble padded tridiagonal systems; pad rows become identity (x = 0)
    a = np.zeros((N, n)); b = np.ones((N, n)); c = np.zeros((N, n)); d = np.zeros((N, n))
    E = D = 1.0
    for i in range(N):
        ns = int(ns_arr[i])
        if ns == 0:
            b[i, 0] = D
            d[i, 0] = R[i]  # C*R
            continue
        # P0 row: (D + k0) P0 - E P1 = C R
        b[i, 0] = D + 1.0
        c[i, 0] = -E
        d[i, 0] = R[i]
        for j in range(1, ns):
            a[i, j] = -1.0                 # -k_{j-1}
            b[i, j] = 1.0 + E + 1.0 + D    # k_j + E + dp_{j-1} + D (see note)
            c[i, j] = -E
        a[i, ns] = -1.0
        b[i, ns] = E + 1.0 + D             # E + dp_{ns-1} + D
        c[i, ns] = 0.0
    x = np.asarray(thomas_solve_batched(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(c), jnp.asarray(d)))

    Y = np.zeros((N, topo.width))
    Y[:, 0] = R
    Y[:, 1] = np.maximum(x[:, 0], 0.0)
    Y[:, 2:] = np.maximum(x[:, 1:], 0.0) * msk
    return Y


def steady_state_combinatorial(topo, TF_inputs=None, tf_scale=1.0,
                               max_states_per_protein=4096) -> np.ndarray:
    """Batched dense hypercube solve (reference steadystate.py:603-752)."""
    N = topo.N
    if topo.max_states > max_states_per_protein:
        raise ValueError(f"2^{topo.max_sites} states exceeds cap "
                         f"{max_states_per_protein}")
    u = _squash(np.zeros(N) if TF_inputs is None else np.asarray(TF_inputs, float))
    synth = np.where(u >= 0, 1.0 + tf_scale * u, 1.0 / (1.0 + tf_scale * np.abs(u)))
    R = np.maximum(synth, 0.0)

    Mmax = topo.max_states
    stmask = topo.state_mask().astype(float)       # (N, Mmax)

    E = D = 1.0
    A = np.zeros((N, Mmax, Mmax))
    for i in range(N):
        ns = int(topo.n_sites[i])
        nst = 1 << ns
        for frm in range(nst):
            if frm == 0:
                A[i, 0, 0] -= D
            mm = frm
            while mm:
                lsb = mm & -mm
                mm -= lsb
                to = frm ^ lsb
                A[i, frm, frm] -= E          # dephospho out
                A[i, to, frm] += E
                A[i, frm, frm] -= (1.0 + D)  # per-bit decay Dp + D
            for j in range(ns):
                bit = 1 << j
                if not frm & bit:
                    A[i, frm, frm] -= 1.0    # phospho out (S = 1)
                    A[i, frm | bit, frm] += 1.0
        # pad rows -> identity so the batched solve stays nonsingular
        for m in range(nst, Mmax):
            A[i, m, m] = 1.0

    b = np.zeros((N, Mmax))
    b[:, 0] = R  # C * R
    P = np.asarray(jnp.linalg.solve(jnp.asarray(A),
                                    jnp.asarray(-b)[..., None]).squeeze(-1))
    P = np.maximum(P, 0.0) * stmask

    Y = np.zeros((N, topo.width))
    Y[:, 0] = R
    Y[:, 1:] = P
    return Y
