"""tfopt: TF -> mRNA algebraic optimization model.

Spec: reference ``tfopt/local/objfn/minfn.py:4-93`` —

    R_hat_g(t) = sum_r alpha_{g,r} * [beta_{r,0} * TFprot_r(t)
                                      + sum_k beta_{r,k} * psite_{r,k}(t)]

with per-gene ``sum_r alpha = 1`` (alpha in [0,1]) and per-TF
``sum beta = 1`` (beta in [lb, ub]; TFs without psites have a single beta
forced to 1). Losses 0..6: MSE, MAE, soft-L1, Cauchy, Arctan, Elastic Net
(MSE + L1 + L2 on beta), Tikhonov (MSE + L2 on beta).

Accelerator-native layout: regulators as a padded (n_genes, n_reg) index matrix
(-1 invalid), beta as padded (n_TF, 1 + n_psite_max); prediction is two
masked einsums; the prange-over-genes Numba loop becomes one matmul.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class TfoptProblem:
    mRNA_mat: np.ndarray        # (n_genes, T)
    regulators: np.ndarray      # (n_genes, n_reg) TF indices, -1 = none
    protein_mat: np.ndarray     # (n_TF, T)
    psite_tensor: np.ndarray    # (n_TF, n_psite_max, T) zero-padded
    num_psites: np.ndarray      # (n_TF,)
    gene_ids: list = None
    tf_ids: list = None
    psite_labels: list = None   # per TF
    lb: float = -4.0
    ub: float = 4.0

    @property
    def n_genes(self):
        return self.mRNA_mat.shape[0]

    @property
    def n_TF(self):
        return self.protein_mat.shape[0]

    @property
    def n_reg(self):
        return self.regulators.shape[1]

    @property
    def n_psite_max(self):
        return self.psite_tensor.shape[1]

    @property
    def no_psite_tf(self):
        return self.num_psites == 0

    @property
    def beta_mask(self) -> np.ndarray:
        """(n_TF, 1 + n_psite_max): protein slot always valid, psite slots
        valid up to num_psites."""
        m = np.zeros((self.n_TF, 1 + self.n_psite_max), bool)
        m[:, 0] = True
        m[:, 1:] = np.arange(self.n_psite_max)[None, :] < self.num_psites[:, None]
        return m

    @property
    def alpha_mask(self) -> np.ndarray:
        return self.regulators >= 0

    @property
    def n_alpha(self):
        return int(self.alpha_mask.sum())

    @property
    def n_beta(self):
        return int(self.beta_mask.sum())

    # flat (reference order: all alphas gene-major, then betas TF-major)
    def pack(self, alpha_pad, beta_pad):
        return np.concatenate([np.asarray(alpha_pad)[self.alpha_mask],
                               np.asarray(beta_pad)[self.beta_mask]])

    def unpack(self, x):
        a = np.zeros(self.alpha_mask.shape)
        b = np.zeros(self.beta_mask.shape)
        a[self.alpha_mask] = np.asarray(x)[: self.n_alpha]
        b[self.beta_mask] = np.asarray(x)[self.n_alpha:self.n_alpha + self.n_beta]
        return a, b


def predict(prob: TfoptProblem, alpha_pad, beta_pad):
    """(n_genes, T) predicted expression, clipped >= 0."""
    bm = jnp.asarray(prob.beta_mask, beta_pad.dtype)
    beta = beta_pad * bm
    # TF effect: beta_0 * protein + sum_k beta_k * psite_k  -> (n_TF, T)
    effect = (beta[:, :1] * jnp.asarray(prob.protein_mat)
              + jnp.einsum("fk,fkt->ft", beta[:, 1:],
                           jnp.asarray(prob.psite_tensor)))
    reg_idx = jnp.maximum(jnp.asarray(prob.regulators), 0)
    am = jnp.asarray(prob.alpha_mask, alpha_pad.dtype)
    eff_sel = effect[reg_idx]                          # (n_genes, n_reg, T)
    pred = jnp.einsum("gr,grt->gt", alpha_pad * am, eff_sel)
    return jnp.maximum(pred, 0.0)


def tfopt_loss(prob: TfoptProblem, alpha_pad, beta_pad, loss_type: int = 0,
               lam1: float = 1e-6, lam2: float = 1e-6):
    """Scalar loss per reference loss_type codes 0-6."""
    R = jnp.asarray(prob.mRNA_mat)
    pred = predict(prob, alpha_pad, beta_pad)
    diff = R - pred
    nT = R.size

    if loss_type == 1:      # MAE
        total = jnp.abs(diff).sum()
    elif loss_type == 2:    # soft L1
        total = (2.0 * (jnp.sqrt(1.0 + diff * diff) - 1.0)).sum()
    elif loss_type == 3:    # Cauchy
        total = jnp.log1p(diff * diff).sum()
    elif loss_type == 4:    # Arctan
        total = jnp.arctan(diff * diff).sum()
    else:                   # MSE (0, 5, 6 base)
        total = (diff * diff).sum()
    loss = total / nT

    bm = jnp.asarray(prob.beta_mask, beta_pad.dtype)
    beta = (beta_pad * bm).ravel()
    if loss_type == 5:      # elastic net on beta
        loss = loss + lam1 * jnp.abs(beta).sum() + lam2 * jnp.dot(beta, beta)
    elif loss_type == 6:    # Tikhonov — lam1 is the L2 coefficient here,
        # NOT lam2 (which is the L2 knob of elastic-net above): this
        # mirrors the reference exactly (tfopt/local/objfn/minfn.py:89-91)
        loss = loss + lam1 * jnp.dot(beta, beta)
    return loss


def violation_sq(prob: TfoptProblem, alpha_pad, beta_pad):
    """(alpha_viol^2, beta_viol^2) — evol objectives 2 and 3."""
    am = jnp.asarray(prob.alpha_mask, alpha_pad.dtype)
    bm = jnp.asarray(prob.beta_mask, beta_pad.dtype)
    has_reg = am.sum(axis=1) > 0
    sa = (alpha_pad * am).sum(axis=1)
    av = jnp.where(has_reg, (sa - 1.0) ** 2, 0.0).sum()
    bv = (((beta_pad * bm).sum(axis=1) - 1.0) ** 2).sum()
    return av, bv
