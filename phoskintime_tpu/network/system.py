"""GlobalSystem: parameters + topology + kinase input, as a functional pytree.

Spec: reference ``global_model/network.py:199-526`` (System). Unlike the
reference — which mutates one shared System per candidate inside process
pools — parameters here are a plain dict pytree threaded functionally
through jitted code, so a population of candidates is just a batch axis.

Parameter pytree (physical space):
  c_k (K,), A_i/B_i/C_i/D_i/E_i (N,), Dp_i (N, Smax) padded, tf_scale ().
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from phoskintime_tpu.network.rhs import PaddedRHS
from phoskintime_tpu.network.topology import NetworkTopology

PARAM_ORDER = ["c_k", "A_i", "B_i", "C_i", "D_i", "Dp_i", "E_i", "tf_scale"]


def default_params(topo: NetworkTopology, dtype=np.float64) -> dict:
    """Neutral defaults (all ones), Dp padded over invalid slots."""
    return {
        "c_k": np.ones(topo.K, dtype),
        "A_i": np.ones(topo.N, dtype),
        "B_i": np.ones(topo.N, dtype),
        "C_i": np.ones(topo.N, dtype),
        "D_i": np.ones(topo.N, dtype),
        "Dp_i": np.ones((topo.N, topo.max_sites), dtype),
        "E_i": np.ones(topo.N, dtype),
        "tf_scale": dtype(1.0),
    }


def flat_site_values(topo: NetworkTopology, padded: np.ndarray) -> np.ndarray:
    """(N, Smax) padded per-site values -> reference flat (total_sites,) order."""
    out = []
    for i in range(topo.N):
        out.append(padded[i, : topo.n_sites[i]])
    return np.concatenate(out) if out else np.zeros(0)


def pad_site_values(topo: NetworkTopology, flat: np.ndarray) -> np.ndarray:
    """Reference flat (total_sites,) per-site values -> padded (N, Smax)."""
    out = np.zeros((topo.N, topo.max_sites), dtype=np.asarray(flat).dtype)
    c = 0
    for i in range(topo.N):
        ns = int(topo.n_sites[i])
        out[i, :ns] = flat[c:c + ns]
        c += ns
    return out


@dataclasses.dataclass
class GlobalSystem:
    """Bundles static topology, kinase input and a default y0."""

    topo: NetworkTopology
    kin_grid: np.ndarray      # protein timepoint grid (bucket boundaries)
    Kmat: np.ndarray          # (K, len(grid))
    custom_y0: np.ndarray | None = None
    dtype: type = np.float64

    def __post_init__(self):
        self.rhs = PaddedRHS(self.topo, self.Kmat,
                             dtype=jnp.float64 if self.dtype == np.float64 else jnp.float32)

    def y0(self) -> np.ndarray:
        """Padded (N, width) initial state.

        Default fallback (reference network.py:421-441): R = 1, main protein
        state 1, phospho states 0.01 (valid slots only).
        """
        if self.custom_y0 is not None:
            return np.array(self.custom_y0, copy=True)
        topo = self.topo
        Y = np.zeros((topo.N, topo.width))
        Y[:, 0] = 1.0
        Y[:, 1] = 1.0
        if topo.model == 2:
            sm = topo.state_mask()
            Y[:, 2:] = 0.01 * sm[:, 1:]
        else:
            Y[:, 2:] = 0.01 * topo.site_mask()
        return Y

    def rhs_flat(self, params):
        """Bucketed RHS closure for the integrator: (t, y_flat, jb) -> dy."""
        return lambda t, y, jb: self.rhs(t, y, jb, params)

    def astype(self, dtype) -> "GlobalSystem":
        """Same topology/input/y0 re-materialized at another working dtype.

        Static inputs (Kmat, grid, y0) are kept at full f64 host precision
        in this dataclass, so the cast is lossless upward: the float64
        variant is the EXACT model whose f32 tensors the production system
        rounds from. Used by the mixed-precision LM finish
        (:func:`phoskintime_tpu.network.polish.lm_refine_mixed`) — f64 on
        the device requires ``jax.config.update("jax_enable_x64", True)``
        before any tracing."""
        if dtype == self.dtype:
            return self
        return GlobalSystem(self.topo, self.kin_grid, self.Kmat,
                            custom_y0=self.custom_y0, dtype=dtype)
