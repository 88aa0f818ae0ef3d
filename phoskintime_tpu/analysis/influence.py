"""State-dependent functional-influence networks of a fitted global model.

Behavioral spec: the network-exploration half of the reference's
mechanism-comparison app (``scripts/compare_mechanisms.py:1063-2100``):
state snapshots at a chosen time, global edge tables built from the
CURRENT model state (kinase→site phospho flux, TF→target synthesis
drive), seed-based cascade propagation to a depth, and temporal sweeps
of the edge tables (the app's gravis/plotly time animation).

Accelerator-native design: ONE exponential simulation yields the state at every
sweep time; the edge tensors for all times come from dense masked
einsums over the padded topology — the reference re-simulates and loops
proteins per snapshot. The sweep is exported as a tidy CSV plus a
self-contained interactive HTML with a time slider (no gravis/plotly).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd


def state_sweep(system, params, times):
    """Simulate once; return (times, Y (T, N, width)) at the sweep grid."""
    import jax.numpy as jnp

    from phoskintime_tpu.network.expo import exponential_simulate

    times = np.asarray(times, float)
    res = exponential_simulate(system, params, jnp.asarray(times))
    N, w = system.topo.N, system.topo.width
    return times, np.asarray(res.ys, float).reshape(len(times), N, w)


def influence_edges_sweep(system, params, times, Y_sweep) -> pd.DataFrame:
    """Edge tables at every sweep time, fully vectorized.

    Kinds:
      ``phospho``: kinase k -> (protein i, site j), weight =
        W[i,j,k] * K_k(t) * c_k * P0_i(t) — the actual phospho flux into
        that site at time t (reference `_build_global_edge_tables`).
      ``tf``: TF src -> target i, weight = tf_mat[i, src] * P_src(t) /
        tf_deg_i — the synthesis-drive contribution before squashing.
    Returns tidy [time, kind, src, dst, site, weight].
    """
    topo = system.topo
    Kmat = np.asarray(system.Kmat, float)
    grid = np.asarray(system.kin_grid, float)
    ck = np.asarray(params["c_k"], float)
    W = np.asarray(topo.W_pad, float)                  # (N, Smax, K)
    tf_mat = np.asarray(topo.tf_mat, float)            # (N, N)
    tf_deg = np.asarray(topo.tf_deg, float)            # (N,)
    smask = np.asarray(topo.site_mask(), bool)

    times = np.asarray(times, float)
    jb = np.clip(np.searchsorted(grid, times, side="right") - 1, 0,
                 Kmat.shape[1] - 1)
    Kt = Kmat[:, jb] * ck[:, None]                     # (K, T)

    if topo.model == 2:
        state_mask = np.asarray(topo.state_mask(), float)
        P0 = (Y_sweep[:, :, 1:] * state_mask[None]).sum(-1)   # total protein
        tot = P0
    else:
        P0 = Y_sweep[:, :, 1]                          # (T, N)
        tot = P0 + (Y_sweep[:, :, 2:] * smask[None]).sum(-1)

    # kinase -> site flux: (T, N, Smax, K)
    flux = np.einsum("nsk,kt,tn->tnsk", W, Kt, P0)
    # TF drive: P_vec with kinase live-drive override
    drv = np.asarray(topo.driver_map)
    P_vec = tot.copy()
    driven = drv >= 0
    P_vec[:, driven] = Kt[drv[driven], :].T
    tf_drive = tf_mat[None] * P_vec[:, None, :] / tf_deg[None, :, None]
    # (T, target, src)

    rows = []
    for t_i, t in enumerate(times):
        for i, prot in enumerate(topo.proteins):
            for j, site in enumerate(topo.sites[i]):
                for k, kin in enumerate(topo.kinases):
                    wgt = flux[t_i, i, j, k]
                    if wgt > 0:
                        rows.append((t, "phospho", kin, prot, site, wgt))
        src_idx, tgt_idx = np.nonzero(tf_mat.T)        # (src, target) pairs
        for s, i in zip(src_idx, tgt_idx):
            wgt = tf_drive[t_i, i, s]
            if wgt != 0:
                rows.append((t, "tf", topo.proteins[s], topo.proteins[i],
                             "", wgt))
    return pd.DataFrame(rows, columns=["time", "kind", "src", "dst",
                                       "site", "weight"])


def cascade_from_seed(edges: pd.DataFrame, seed: str, depth: int = 3,
                      rel_threshold: float = 0.05) -> pd.DataFrame:
    """Breadth-first influence cascade from a seed node over one
    snapshot's edges (reference `_cascade_edges_from_seed`).

    Edge influence = weight / max sibling weight at the source; paths
    keep the product; edges below ``rel_threshold`` influence prune.
    Returns [src, dst, site, kind, weight, influence, depth].
    """
    e = edges.copy()
    e["rel"] = e.groupby("src")["weight"].transform(
        lambda s: s / max(float(s.abs().max()), 1e-12))
    out = []
    frontier = {str(seed): 1.0}
    seen = {str(seed)}
    for d in range(1, depth + 1):
        nxt: dict[str, float] = {}
        for src, infl in frontier.items():
            sub = e[e["src"] == src]
            for _, r in sub.iterrows():
                f = infl * abs(float(r["rel"]))
                if f < rel_threshold:
                    continue
                out.append((r["src"], r["dst"], r["site"], r["kind"],
                            float(r["weight"]), f, d))
                if r["dst"] not in seen:
                    nxt[r["dst"]] = max(nxt.get(r["dst"], 0.0), f)
        seen |= set(nxt)
        frontier = nxt
        if not frontier:
            break
    return pd.DataFrame(out, columns=["src", "dst", "site", "kind",
                                      "weight", "influence", "depth"])


def export_influence_sweep(system, params, out_dir, times=None,
                           seeds=None, depth: int = 3) -> dict:
    """Full influence analysis: sweep CSV, per-seed cascade CSVs, and the
    interactive time-slider network HTML."""
    os.makedirs(out_dir, exist_ok=True)
    topo = system.topo
    if times is None:
        g = np.asarray(system.kin_grid, float)
        times = g[:: max(1, len(g) // 8)]
    times, Y = state_sweep(system, params, times)
    edges = influence_edges_sweep(system, params, times, Y)
    edges.to_csv(os.path.join(out_dir, "influence_sweep.csv"), index=False)

    out = {"sweep_csv": os.path.join(out_dir, "influence_sweep.csv"),
           "cascades": {}}
    t_last = float(times[-1])
    snap = edges[edges["time"] == t_last]
    if seeds is None:
        seeds = list(topo.kinases[:2])
    for seed in seeds:
        cas = cascade_from_seed(snap, seed, depth=depth)
        p = os.path.join(out_dir, f"cascade_{seed}.csv")
        cas.to_csv(p, index=False)
        out["cascades"][seed] = p

    out["html"] = write_influence_html(
        os.path.join(out_dir, "influence_network.html"), edges,
        kinases=set(topo.kinases))
    return out


def write_influence_html(path, edges: pd.DataFrame, kinases=frozenset(),
                         max_edges_per_time: int = 150) -> str:
    """Time-slider network: the functional-influence edges at each sweep
    time as a layered SVG (kinases left, proteins right), edge widths
    scaled per-frame; replaces the reference app's gravis/plotly
    animation with one dependency-free HTML file."""
    from phoskintime_tpu.report.interactive import _CSS

    times = sorted(set(float(t) for t in edges["time"]))
    frames = []
    nodes = set()
    for t in times:
        sub = (edges[edges["time"] == t]
               .sort_values("weight", key=lambda s: s.abs(),
                            ascending=False)
               .head(max_edges_per_time))
        fr = [{"s": str(r["src"]),
               "t": str(r["dst"]) + (f":{r['site']}" if r["site"] else ""),
               "w": float(r["weight"]), "k": str(r["kind"])}
              for _, r in sub.iterrows()]
        frames.append(fr)
        for e in fr:
            nodes.add(e["s"])
            nodes.add(e["t"])
    node_list = [{"id": n, "layer": "0" if n in kinases else "1"}
                 for n in sorted(nodes)]
    data = {"times": times, "frames": frames, "nodes": node_list}

    js = """
'use strict';
var D = window.__INFLDATA__;
function el(tag, attrs) {
  var e = document.createElementNS('http://www.w3.org/2000/svg', tag);
  for (var k in (attrs || {})) e.setAttribute(k, attrs[k]);
  return e;
}
var svg = document.getElementById('infl-svg');
var W = +svg.getAttribute('width'), H = +svg.getAttribute('height');
var layers = {};
D.nodes.forEach(function (n) {
  (layers[n.layer] = layers[n.layer] || []).push(n); });
Object.keys(layers).sort().forEach(function (ly, li, arr) {
  layers[ly].forEach(function (n, i) {
    n.x = 90 + (W - 220) * li / Math.max(1, arr.length - 1);
    n.y = 30 + (H - 60) * (i + 0.5) / layers[ly].length;
  });
});
var byId = {};
D.nodes.forEach(function (n) { byId[n.id] = n; });
var slider = document.getElementById('t-slider');
slider.max = D.times.length - 1;
function draw() {
  while (svg.firstChild) svg.removeChild(svg.firstChild);
  var fi = +slider.value;
  document.getElementById('t-label').textContent = D.times[fi];
  var fr = D.frames[fi];
  var wmax = fr.reduce(function (a, e) {
    return Math.max(a, Math.abs(e.w)); }, 1e-12);
  fr.forEach(function (e) {
    var a = byId[e.s], b = byId[e.t];
    if (!a || !b) return;
    var p = el('path', {
      d: 'M' + a.x + ',' + a.y + ' C' + ((a.x + b.x) / 2) + ',' + a.y + ' '
        + ((a.x + b.x) / 2) + ',' + b.y + ' ' + b.x + ',' + b.y,
      fill: 'none', stroke: e.k === 'tf' ? '#b07d2b' : '#1461d6',
      'stroke-opacity': 0.55,
      'stroke-width': (0.5 + 5.0 * Math.abs(e.w) / wmax).toFixed(2)});
    var ti = el('title');
    ti.textContent = e.s + ' -> ' + e.t + '  (' + e.k + ')  w='
      + e.w.toPrecision(4);
    p.appendChild(ti);
    svg.appendChild(p);
  });
  D.nodes.forEach(function (n) {
    svg.appendChild(el('circle', {cx: n.x, cy: n.y, r: 5,
      fill: n.layer === '0' ? '#1a1a2e' : '#1461d6',
      stroke: '#fff', 'stroke-width': 1}));
    var t = el('text', {x: n.x + 8, y: n.y + 3, 'font-size': 9,
      fill: '#333'});
    t.textContent = n.id;
    svg.appendChild(t);
  });
}
slider.addEventListener('input', draw);
draw();
"""
    html = f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>Functional influence network</title><style>{_CSS}</style></head>
<body>
<header><h1>Functional influence over time</h1>
<div class="sub">edge width = |influence| at the selected time; blue =
phospho flux, amber = TF synthesis drive</div></header>
<div class="wrap"><div class="card">
<div class="row">t = <b id="t-label">-</b>
<input id="t-slider" type="range" min="0" value="0" style="flex:1"></div>
<svg id="infl-svg" width="1100" height="560"></svg>
</div></div>
<script>window.__INFLDATA__ = {json.dumps(data)};</script>
<script>{js}</script>
</body></html>
"""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write(html)
    return path


def export_global_knockout_explorer(system, params, out_path,
                                    times=None) -> str:
    """Interactive global-model knockout explorer: each kinase's drive is
    zeroed in turn and the FULL network re-simulated — all scenarios plus
    the wild type as ONE batched exponential simulation — then rendered
    with the same single-file explorer used for kinopt/tfopt (curve
    browser, before/after knockout overlays, network view).

    Spec: the global-knockout preview capability of the reference's
    mechanism-comparison app (``scripts/compare_mechanisms.py`` knockout
    sweep + gravis rendering).
    """
    import jax.numpy as jnp

    from phoskintime_tpu.network.expo import exponential_simulate_batched
    from phoskintime_tpu.network.simulate import (extract_observables,
                                                  fold_changes)
    from phoskintime_tpu.report.interactive import write_interactive_explorer

    topo = system.topo
    if times is None:
        times = np.asarray(system.kin_grid, float)
    times = np.asarray(times, float)
    K = topo.K

    ck = np.asarray(params["c_k"], float)
    ck_b = np.vstack([ck[None], np.repeat(ck[None], K, 0)])
    for k in range(K):
        ck_b[1 + k, k] = 0.0                  # scenario k+1: kinase k out
    params_b = {key: (jnp.asarray(ck_b) if key == "c_k"
                      else jnp.asarray(np.repeat(
                          np.asarray(v)[None], K + 1, 0)))
                for key, v in params.items()}

    ys, _ = exponential_simulate_batched(system, params_b, times)

    def fcs(Y):
        import jax

        return jax.vmap(lambda y: fold_changes(
            extract_observables(system, y), jnp.asarray(times)))(Y)

    fc_r, fc_p, fc_ph = (np.asarray(a, float) for a in fcs(ys))
    smask = np.asarray(topo.site_mask(), bool)

    curve_names, rows_wt, rows_ko = [], [], []
    for i, p in enumerate(topo.proteins):
        curve_names.append(f"{p} (protein)")
        rows_wt.append(fc_p[0, :, i])
        rows_ko.append(fc_p[1:, :, i])
        curve_names.append(f"{p} (mRNA)")
        rows_wt.append(fc_r[0, :, i])
        rows_ko.append(fc_r[1:, :, i])
        for j, s in enumerate(topo.sites[i]):
            curve_names.append(f"{p}:{s}")
            rows_wt.append(fc_ph[0, :, i, j])
            rows_ko.append(fc_ph[1:, :, i, j])
    est = np.stack(rows_wt)                              # (C, T)
    ko_est = np.stack(rows_ko, axis=1)                   # (K, C, T)

    # static control edges for the network panel
    W = np.asarray(topo.W_pad, float)
    edge_rows = []
    for i, p in enumerate(topo.proteins):
        for j, s in enumerate(topo.sites[i]):
            for k, kin in enumerate(topo.kinases):
                if W[i, j, k] > 0:
                    edge_rows.append((kin, f"{p}:{s}", W[i, j, k]))
    tf_mat = np.asarray(topo.tf_mat, float)
    src_i, tgt_i = np.nonzero(tf_mat.T)
    for s_, i in zip(src_i, tgt_i):
        edge_rows.append((topo.proteins[s_], f"{topo.proteins[i]} (protein)",
                          tf_mat[i, s_]))
    edges = pd.DataFrame(edge_rows, columns=["source", "target", "weight"])

    return write_interactive_explorer(
        out_path, title="global-model knockout explorer",
        times=times, curve_names=curve_names, obs=None, est=est,
        ko_names=[f"ΔKinase {k}" for k in topo.kinases], ko_est=ko_est,
        network_edges=edges, source_layer_names=set(topo.kinases))
