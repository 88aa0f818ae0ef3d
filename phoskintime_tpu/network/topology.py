"""Network topology: name <-> index maps, padded layouts, proxy redirection.

Spec: reference ``global_model/network.py:28-167`` (Index) and
``global_model/buildmat.py`` (W / TF matrix builders, ``site_key`` ordering).

Accelerator-native layout: instead of a ragged flat state vector with per-protein
offsets, the state is a **padded (N, width) matrix** with boolean masks:

* models 0/1/4: ``Y[i] = [R, P0, site_1..site_Smax]`` (width = 2 + Smax)
* model 2:      ``Y[i] = [R, X_0..X_{Mmax-1}]``        (width = 1 + 2^Smax)

All downstream kernels (RHS, loss, steady states) are dense masked einsums
over this layout — no gather/scatter per protein, no Python loops.

Orphan-TF proxy redirection (reference network.py:75-113): TFs with no
phospho sites in the signaling data are "driven" by the kinase they target,
expressed here purely through ``driver map`` and shared observable rows —
no index hijacking needed because drivers override P_vec anyway.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


def site_key(site: str):
    """Sort key: residue number then string (reference buildmat.py:25-41)."""
    m = re.search(r"(\d+)", str(site))
    return (int(m.group(1)) if m else 10 ** 9, str(site))


@dataclasses.dataclass
class NetworkTopology:
    """Static description of the kinase-substrate / TF-gene network."""

    proteins: list[str]
    kinases: list[str]
    sites: list[list[str]]          # per protein, residue-sorted
    n_sites: np.ndarray             # (N,) int32
    p2i: dict[str, int]
    k2i: dict[str, int]
    proxy_map: dict[str, str]       # orphan TF -> proxy kinase
    driver_map: np.ndarray          # (N,) int32; >=0 kinase idx, -1 simulated
    W_pad: np.ndarray               # (N, Smax, K) kinase->site weights
    tf_mat: np.ndarray              # (N, N) regulator->gene weights
    tf_deg: np.ndarray              # (N,) input normalizer
    model: int = 0

    # ------------------------------------------------------------------
    @property
    def N(self) -> int:
        return len(self.proteins)

    @property
    def K(self) -> int:
        return len(self.kinases)

    @property
    def max_sites(self) -> int:
        return int(self.W_pad.shape[1])

    @property
    def total_sites(self) -> int:
        return int(self.n_sites.sum())

    @property
    def n_states(self) -> np.ndarray:
        return (1 << self.n_sites.astype(np.int64)).astype(np.int32)

    @property
    def max_states(self) -> int:
        return 1 << self.max_sites

    @property
    def width(self) -> int:
        return (1 + self.max_states) if self.model == 2 else (2 + self.max_sites)

    @property
    def state_dim(self) -> int:
        """Reference-equivalent ragged state dimension (for parity checks)."""
        if self.model == 2:
            return int(np.sum(1 + self.n_states))
        return int(np.sum(2 + self.n_sites))

    def site_mask(self) -> np.ndarray:
        """(N, Smax) bool: site slot j valid for protein i."""
        return np.arange(self.max_sites)[None, :] < self.n_sites[:, None]

    def state_mask(self) -> np.ndarray:
        """(N, Mmax) bool: bitmask state m valid for protein i (model 2)."""
        return np.arange(self.max_states)[None, :] < self.n_states[:, None]

    def site_slot(self, protein: str, psite: str) -> int:
        i = self.p2i[protein]
        return self.sites[i].index(psite)


def build_topology(interactions,
                   tf_interactions=None,
                   kin_beta_map: dict | None = None,
                   tf_beta_map: dict | None = None,
                   kin_alpha: dict | None = None,
                   tf_edge_weights: dict | None = None,
                   model: int = 0,
                   max_sites_cap: int | None = None) -> NetworkTopology:
    """Build a :class:`NetworkTopology` from tidy interaction tables.

    Args:
      interactions: DataFrame [protein, psite, kinase] kinase-substrate edges.
      tf_interactions: DataFrame [tf, target] regulator edges (optional).
      kin_beta_map / tf_beta_map: optional priors used to pick the best
        proxy kinase for orphan TFs (reference network.py:92-105).
      kin_alpha: optional {(protein, psite, kinase): alpha} edge weights for
        W (defaults 1.0).
      tf_edge_weights: optional {(tf, target): weight} for the TF matrix
        (defaults 1.0).
      model: mechanism id (0/1/2/4); model 2 uses bitmask states.
      max_sites_cap: optional clamp on sites per protein (model 2 blowup guard).
    """
    prots = set(interactions["protein"].unique())
    if tf_interactions is not None:
        if "tf" in tf_interactions.columns:
            prots.update(tf_interactions["tf"].unique())
        if "target" in tf_interactions.columns:
            prots.update(tf_interactions["target"].unique())
    proteins = sorted(prots)
    p2i = {p: i for i, p in enumerate(proteins)}

    kinases = sorted(interactions["kinase"].unique().tolist())
    k2i = {k: i for i, k in enumerate(kinases)}

    # --- orphan TF proxy selection (behavioral spec network.py:75-113) ---
    proxy_map: dict[str, str] = {}
    if tf_interactions is not None and len(tf_interactions):
        with_sites = set(interactions["protein"].unique())
        orphan_tfs = set(tf_interactions["tf"].unique()) - with_sites
        for orphan in sorted(orphan_tfs):
            targets = tf_interactions.loc[tf_interactions["tf"] == orphan, "target"]
            feedback = [t for t in targets if t in k2i]
            if not feedback:
                continue
            best, best_w = feedback[0], -1.0
            for k in feedback:
                # NOTE: the tf_beta term is constant across candidates —
                # only the kinase beta can change the argmax; reproduced
                # as-is from reference network.py:99-101
                w = (tf_beta_map or {}).get(orphan, 0.0)
                w += (kin_beta_map or {}).get(k, 0.0)
                if w > best_w:
                    best_w, best = w, k
            proxy_map[orphan] = best

    # --- per-protein site lists -----------------------------------------
    sites: list[list[str]] = []
    for p in proteins:
        sub = interactions.loc[interactions["protein"] == p, "psite"].dropna().unique().tolist()
        s_list = sorted(sub, key=site_key)
        if max_sites_cap is not None:
            s_list = s_list[:max_sites_cap]
        sites.append(s_list)
    n_sites = np.asarray([len(s) for s in sites], np.int32)
    Smax = max(1, int(n_sites.max()) if len(n_sites) else 1)

    # --- padded W (kinase -> site) ---------------------------------------
    K = len(kinases)
    W_pad = np.zeros((len(proteins), Smax, K))
    for _, row in interactions.iterrows():
        p, s, k = row["protein"], row["psite"], row["kinase"]
        if p not in p2i or k not in k2i:
            continue
        i = p2i[p]
        if s not in sites[i]:
            continue
        j = sites[i].index(s)
        alpha = 1.0
        if kin_alpha is not None:
            alpha = float(kin_alpha.get((p, s, k), 1.0))
        W_pad[i, j, k2i[k]] += alpha

    # --- TF matrix (regulator -> gene) -----------------------------------
    N = len(proteins)
    tf_mat = np.zeros((N, N))
    if tf_interactions is not None:
        for _, row in tf_interactions.iterrows():
            tf, tgt = row["tf"], row["target"]
            if tf not in p2i or tgt not in p2i:
                continue
            w = 1.0
            if tf_edge_weights is not None:
                w = float(tf_edge_weights.get((tf, tgt), 1.0))
            tf_mat[p2i[tgt], p2i[tf]] += w

    # input normalizer: sum of |edge weights| per gene, floored
    # (reference runner.py:507-508)
    deg = np.abs(tf_mat).sum(axis=1).astype(float)
    deg[deg < 1e-12] = 1.0

    # --- driver map -------------------------------------------------------
    driver_map = np.full(N, -1, np.int32)
    for k in kinases:
        if k in p2i:
            driver_map[p2i[k]] = k2i[k]
    for orphan, proxy in proxy_map.items():
        if orphan in p2i:
            driver_map[p2i[orphan]] = k2i[proxy]

    return NetworkTopology(proteins, kinases, sites, n_sites, p2i, k2i,
                           proxy_map, driver_map, W_pad, tf_mat, deg, model)
