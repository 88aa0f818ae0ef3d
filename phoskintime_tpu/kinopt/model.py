"""kinopt: kinase -> phosphosite algebraic optimization model.

Spec: reference ``kinopt/evol/objfn/minfndiffevo.py:148-386`` —

    P_hat_i(t) = sum_j alpha_{i,j} * A_j(t),
    A_j(t)     = sum_p beta_{j,p} * K_p(t),

with per-site ``sum_j alpha_{i,j} = 1`` and per-kinase
``sum_p beta_{j,p} = 1`` constraints, bounds [-4, 4], losses
base(MSE)/autocorrelation(lag-1 r^2)/huber/mape with optional L1+L2
regularization.

Accelerator-native layout: ragged alpha/beta groups become padded index matrices
with masks; the two-stage accumulation is two masked einsums (dense matmuls),
and a multistart population is one extra vmap axis.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class KinoptProblem:
    """Static padded description of the kinase->site assignment problem."""

    P_obs: np.ndarray             # (n_gp, T) observed phospho time series
    K_array: np.ndarray           # (n_rows, T) kinase-signal source rows
    gp_kin_idx: np.ndarray        # (n_gp, Amax) kinase index per alpha slot
    gp_mask: np.ndarray           # (n_gp, Amax) valid alpha slots
    k_row_idx: np.ndarray         # (n_k, Bmax) K_array row per beta slot
    k_mask: np.ndarray            # (n_k, Bmax) valid beta slots
    gp_names: list = None         # [(gene, psite)]
    kinase_names: list = None
    lb: float = -4.0
    ub: float = 4.0

    @property
    def n_gp(self):
        return self.P_obs.shape[0]

    @property
    def n_k(self):
        return self.k_row_idx.shape[0]

    @property
    def n_alpha(self):
        return int(self.gp_mask.sum())

    @property
    def n_beta(self):
        return int(self.k_mask.sum())

    # ---- flat (reference-order) <-> padded parameter conversion ----------
    def pack(self, alpha_pad: np.ndarray, beta_pad: np.ndarray) -> np.ndarray:
        return np.concatenate([np.asarray(alpha_pad)[self.gp_mask],
                               np.asarray(beta_pad)[self.k_mask]])

    def unpack(self, x: np.ndarray):
        a = np.zeros(self.gp_mask.shape)
        b = np.zeros(self.k_mask.shape)
        a[self.gp_mask] = np.asarray(x)[: self.n_alpha]
        b[self.k_mask] = np.asarray(x)[self.n_alpha:self.n_alpha + self.n_beta]
        return a, b


def build_problem(P_obs, site_kinases: list[list[int]],
                  kinase_rows: list[list[int]], K_array,
                  gp_names=None, kinase_names=None,
                  lb=-4.0, ub=4.0) -> KinoptProblem:
    """Assemble padded index tables from ragged group lists."""
    n_gp = len(site_kinases)
    n_k = len(kinase_rows)
    Amax = max(1, max((len(s) for s in site_kinases), default=1))
    Bmax = max(1, max((len(r) for r in kinase_rows), default=1))
    gp_kin_idx = np.zeros((n_gp, Amax), np.int32)
    gp_mask = np.zeros((n_gp, Amax), bool)
    for i, ks in enumerate(site_kinases):
        gp_kin_idx[i, :len(ks)] = ks
        gp_mask[i, :len(ks)] = True
    k_row_idx = np.zeros((n_k, Bmax), np.int32)
    k_mask = np.zeros((n_k, Bmax), bool)
    for j, rows in enumerate(kinase_rows):
        k_row_idx[j, :len(rows)] = rows
        k_mask[j, :len(rows)] = True
    return KinoptProblem(np.asarray(P_obs, float), np.asarray(K_array, float),
                         gp_kin_idx, gp_mask, k_row_idx, k_mask,
                         gp_names, kinase_names, lb, ub)


# ---------------------------------------------------------------------------
# prediction + losses (jax)
# ---------------------------------------------------------------------------

def predict(prob: KinoptProblem, alpha_pad, beta_pad):
    """(n_gp, T) predictions; negatives clipped (reference :196-205)."""
    K = jnp.asarray(prob.K_array)
    kmask = jnp.asarray(prob.k_mask, alpha_pad.dtype)
    # kinase signal: sum over beta slots of beta * K[row]
    K_sel = K[jnp.asarray(prob.k_row_idx)]              # (n_k, Bmax, T)
    signal = jnp.einsum("kb,kbt->kt", beta_pad * kmask, K_sel)
    gmask = jnp.asarray(prob.gp_mask, alpha_pad.dtype)
    S_sel = signal[jnp.asarray(prob.gp_kin_idx)]        # (n_gp, Amax, T)
    pred = jnp.einsum("ga,gat->gt", alpha_pad * gmask, S_sel)
    return jnp.maximum(pred, 0.0)


def _corr_sq_lag1(res):
    """Squared lag-1 autocorrelation per row (reference :105-147)."""
    x0 = res[:, :-1] - res[:, :-1].mean(axis=1, keepdims=True)
    x1 = res[:, 1:] - res[:, 1:].mean(axis=1, keepdims=True)
    cov = (x0 * x1).sum(axis=1)
    v0 = (x0 * x0).sum(axis=1)
    v1 = (x1 * x1).sum(axis=1)
    denom = v0 * v1
    r = jnp.where(denom > 0, cov / jnp.sqrt(jnp.maximum(denom, 1e-300)), 0.0)
    return r * r


def kinopt_loss(prob: KinoptProblem, alpha_pad, beta_pad,
                loss_type: str = "base", include_reg: bool = False):
    """Scalar loss.

    evol losses (reference kinopt/evol/objfn/minfndiffevo.py:209-317):
    base / autocorrelation / huber / mape; local losses
    (kinopt/local/objfn/minfn.py:75-99): weighted (inverse-variance time
    weights), softl1, cauchy, arctan.
    """
    P = jnp.asarray(prob.P_obs)
    pred = predict(prob, alpha_pad, beta_pad)
    res = P - pred
    n_scalar = P.size

    if loss_type == "autocorrelation":
        val = _corr_sq_lag1(res).sum()
    elif loss_type == "huber":
        delta = 1.0
        a = jnp.abs(res)
        h = jnp.where(a <= delta, 0.5 * res * res, delta * (a - 0.5 * delta))
        val = h.sum() / n_scalar
    elif loss_type == "mape":
        val = (jnp.abs(res / (P + 1e-12))).sum() / n_scalar * 100.0
    elif loss_type == "weighted":
        # inverse per-timepoint variance (reference construct.py:236-256)
        var_t = jnp.var(P, axis=0)
        tw = 1.0 / (var_t + 1e-8)
        val = (tw[None, :] * res * res).sum() / (tw.sum() * P.shape[0])
    elif loss_type == "softl1":
        val = (2.0 * (jnp.sqrt(1.0 + 0.5 * res * res) - 1.0)).sum() / P.shape[0]
    elif loss_type == "cauchy":
        val = jnp.log1p(0.5 * res * res).sum() / P.shape[0]
    elif loss_type == "arctan":
        val = jnp.arctan(res * res).sum() / P.shape[0]
    else:  # base MSE
        val = (res * res).sum() / n_scalar

    if include_reg:
        # UNWEIGHTED L1+L2 (coefficient 1.0) — reference-faithful: the
        # reference evol objectives add `val + l1 + l2` with no lambda
        # (kinopt/evol/objfn/minfndiffevo.py:239-245), so with simplex
        # constraints the penalty can rival the data loss; kept as-is
        # for parity, flagged in review
        gm = jnp.asarray(prob.gp_mask, alpha_pad.dtype)
        km = jnp.asarray(prob.k_mask, beta_pad.dtype)
        params = jnp.concatenate([(alpha_pad * gm).ravel(), (beta_pad * km).ravel()])
        val = val + jnp.abs(params).sum() + (params ** 2).sum()
    return val


def constraint_violations(prob: KinoptProblem, alpha_pad, beta_pad,
                          eps_eq: float = 1e-6):
    """g(x) <= 0 pairs per group (reference :320-386): |sum - 1| - eps."""
    gm = jnp.asarray(prob.gp_mask, alpha_pad.dtype)
    km = jnp.asarray(prob.k_mask, beta_pad.dtype)
    sa = (alpha_pad * gm).sum(axis=1)
    sb = (beta_pad * km).sum(axis=1)
    g = jnp.concatenate([(sa - 1.0) - eps_eq, (1.0 - sa) - eps_eq,
                         (sb - 1.0) - eps_eq, (1.0 - sb) - eps_eq])
    return g


def violation_sq(prob: KinoptProblem, alpha_pad, beta_pad):
    """(alpha_violation^2, beta_violation^2) — NSGA objectives 2 and 3."""
    gm = jnp.asarray(prob.gp_mask, alpha_pad.dtype)
    km = jnp.asarray(prob.k_mask, beta_pad.dtype)
    av = (((alpha_pad * gm).sum(axis=1) - 1.0) ** 2).sum()
    bv = (((beta_pad * km).sum(axis=1) - 1.0) ** 2).sum()
    return av, bv


def estimated_series(prob: KinoptProblem, alpha_pad, beta_pad):
    return predict(prob, jnp.asarray(alpha_pad), jnp.asarray(beta_pad))
