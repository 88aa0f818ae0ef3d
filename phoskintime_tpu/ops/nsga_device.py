"""Fully on-device U-NSGA-III: variation, evaluation AND survival in XLA.

The host-side GA (:mod:`phoskintime_tpu.ops.nsga`) dispatches one device
program per generation and keeps environmental selection on the host —
cheap in absolute terms with the native C++ sort, but it serializes a
host round-trip per generation: at the north-star shape the device
idles through the dispatch latency plus the host bookkeeping of every
generation.

This module closes that gap the accelerator-native way: the WHOLE generation —
tournament, SBX, polynomial mutation, clone repair, population
evaluation, non-dominated ranking, NSGA-III normalization/association
and niching survival — is one jitted program, and `lax.scan` runs
``gens_per_block`` generations per dispatch. Population state (X, F,
rank, niche, nd) never leaves the device between dispatches; the host
sees only the tiny per-generation ideal/mean history, so dispatch
latency and host time amortize by the block length. Under a
``jax.sharding.Mesh`` the population axis stays sharded through variation
and evaluation, and the (2P, 2P) dominance ranking runs COLUMN-SHARDED
across devices (see :func:`device_nd_ranks`) so the north-star 10k-member
ensemble ranks at 1/n_dev memory/bandwidth per device; the O(P) niche
bookkeeping vectors stay replicated (they are tiny).

Reference anchor: pymoo UNSGA3 semantics as configured by
``global_model/runner.py:663-702`` (same operator distributions and
survival rules as the host path; jax RNG stream instead of numpy, so
draws differ but distributions match — see tests/test_nsga_device.py
for the machinery-equality and convergence evidence).
"""

from __future__ import annotations

import numpy as np

from phoskintime_tpu.ops.nsga import MOOResult, das_dennis, \
    fast_non_dominated_sort, lhs_sampling
from phoskintime_tpu.parallel.mesh import sharded_jit


# ---------------------------------------------------------------------------
# variation (shared with make_device_ga_step)
# ---------------------------------------------------------------------------

def variation_kernel(X, rank, nd, key, xl_j, xu_j, *, pop_size: int,
                     n_var: int, sbx_prob=0.9, sbx_eta=15.0, pm_eta=10.0):
    """One U-NSGA-III variation pass as pure jnp: binary tournament
    (rank, tie-broken by ref-line distance), SBX, polynomial mutation,
    bound clip and clone repair. Returns (pop_size, n_var) offspring.

    Operator forms mirror the host ops (:func:`nsga.sbx_crossover`,
    :func:`nsga.polynomial_mutation`) — same distributions, jax draws."""
    import jax
    import jax.numpy as jnp

    f32 = X.dtype
    ka, kb, kcx, ku, ksw, kmd, kmu, kr1, kr2 = jax.random.split(key, 9)
    span = jnp.where(xu_j - xl_j > 0, xu_j - xl_j, 1.0)

    def tourney(k):
        k1, k2 = jax.random.split(k)
        a = jax.random.randint(k1, (pop_size,), 0, pop_size)
        b = jax.random.randint(k2, (pop_size,), 0, pop_size)
        return jnp.where(rank[a] < rank[b], a,
                         jnp.where(rank[b] < rank[a], b,
                                   jnp.where(nd[a] <= nd[b], a, b)))

    Xa = X[tourney(ka)]
    Xb = X[tourney(kb)]
    # SBX (pymoo-compatible single fused power, as the host op)
    do_cx = jax.random.uniform(kcx, (pop_size,)) <= sbx_prob
    u = jax.random.uniform(ku, (pop_size, n_var), f32)
    base = jnp.where(u <= 0.5, 2 * u, 1.0 / jnp.maximum(2 * (1 - u), 1e-7))
    beta = base ** jnp.asarray(1.0 / (sbx_eta + 1.0), f32)
    swap = jax.random.uniform(ksw, (pop_size, n_var)) <= 0.5
    c1 = 0.5 * ((1 + beta) * Xa + (1 - beta) * Xb)
    c2 = 0.5 * ((1 - beta) * Xa + (1 + beta) * Xb)
    off = jnp.where(swap, c2, c1)
    off = jnp.where(do_cx[:, None], off, Xa)
    off = jnp.clip(off, xl_j, xu_j)
    # polynomial mutation, dense (elementwise full-matrix powers are cheap)
    do_m = jax.random.uniform(kmd, (pop_size, n_var)) <= (1.0 / n_var)
    um = jax.random.uniform(kmu, (pop_size, n_var), f32)
    d1 = (off - xl_j) / span
    d2 = (xu_j - off) / span
    mp = jnp.asarray(1.0 / (pm_eta + 1.0), f32)
    val_lo = 2 * um + (1 - 2 * um) * (1 - d1) ** (pm_eta + 1)
    val_hi = 2 * (1 - um) + 2 * (um - 0.5) * (1 - d2) ** (pm_eta + 1)
    delta = jnp.where(um <= 0.5, val_lo ** mp - 1.0, 1.0 - val_hi ** mp)
    off = jnp.where(do_m, off + delta * span, off)
    off = jnp.clip(off, xl_j, xu_j)
    # clone repair (in-kernel duplicate elimination): an offspring that
    # left the pipeline identical to its first parent gets one uniformly
    # resampled coordinate
    clone = jnp.all(off == Xa, axis=1)
    j = jax.random.randint(kr1, (pop_size,), 0, n_var)
    newv = xl_j[j] + jax.random.uniform(kr2, (pop_size,), f32) \
        * (xu_j[j] - xl_j[j])
    hit = clone[:, None] & (jnp.arange(n_var)[None, :] == j[:, None])
    return jnp.where(hit, newv[:, None], off)


# ---------------------------------------------------------------------------
# on-device environmental selection
# ---------------------------------------------------------------------------

def device_nd_ranks(F, mesh=None):
    """Non-dominated front index per row, on device.

    Uses the longest-dominator-chain identity: front(j) = max over
    dominators i of front(i)+1 (0 if none) — a max-plus fixpoint that
    converges in #fronts iterations of one masked (Q, Q) reduction,
    instead of the host's sequential front peeling.

    With ``mesh`` (a Mesh with a "pop" axis) the (Q, Q) dominance matrix
    is COLUMN-sharded across devices — each device owns dom[:, local] and
    updates the ranks of its own column block; only the (Q,) rank vector
    crosses the interconnect per fixpoint iteration (an all-gather of 4Q bytes).
    Semantics are exactly the replicated computation's; this is what lets
    the all-device GA rank the north-star 10k-member ensemble (a (20k)^2
    matrix) at 1/n_dev of the memory and bandwidth per device
    (VERDICT r3 item 3)."""
    import jax.numpy as jnp
    from jax import lax

    le = jnp.all(F[:, None, :] <= F[None, :, :], axis=-1)
    lt = jnp.any(F[:, None, :] < F[None, :, :], axis=-1)
    dom = le & lt                                  # dom[i, j]: i dominates j
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as Pspec

        dom = lax.with_sharding_constraint(
            dom, NamedSharding(mesh, Pspec(None, "pop")))

    def cond(st):
        return st[1]

    def body(st):
        r, _ = st
        # column block j reads the FULL r (broadcast over rows) and
        # writes r[j]: under the column sharding each device reduces its
        # own (Q, Q/n_dev) block; XLA all-gathers the (Q,) result
        nr = jnp.max(jnp.where(dom, r[:, None] + 1, 0), axis=0)
        return nr, jnp.any(nr != r)

    r0 = jnp.zeros(F.shape[0], jnp.int32)
    r, _ = lax.while_loop(cond, body, (r0, jnp.asarray(True)))
    return r


def _device_normalize(F):
    """NSGA-III ideal/intercept normalization (host semantics of
    :func:`nsga._hyperplane_intercepts`, branch-free)."""
    import jax.numpy as jnp

    m = F.shape[1]
    ideal = jnp.min(F, axis=0)
    Fs = F - ideal
    W = jnp.where(jnp.eye(m, dtype=bool), 1.0, 1e-6)       # (m, m) ASF axes
    asf = jnp.max(Fs[None, :, :] / W[:, None, :], axis=-1)  # (m, Q)
    E = Fs[jnp.argmin(asf, axis=1)]                         # (m, m) extremes
    plane = jnp.linalg.solve(E, jnp.ones(m, F.dtype))
    icpt = jnp.where(plane != 0, 1.0 / jnp.where(plane != 0, plane, 1.0),
                     jnp.inf)
    fallback = jnp.max(Fs, axis=0)
    bad = jnp.any(icpt < 1e-10) | ~jnp.all(jnp.isfinite(icpt))
    icpt = jnp.where(bad, fallback, icpt)
    icpt = jnp.where(icpt > 1e-10, icpt, fallback + 1e-10)
    return Fs / icpt


def _device_associate(Fn, unit_refs):
    """Closest reference line (perpendicular distance) per row."""
    import jax.numpy as jnp

    proj = Fn @ unit_refs.T                                # (Q, R)
    d2 = jnp.sum(Fn ** 2, axis=1)[:, None] - proj ** 2
    dist = jnp.sqrt(jnp.maximum(d2, 0.0))
    niche = jnp.argmin(dist, axis=1)
    return niche, jnp.take_along_axis(dist, niche[:, None], axis=1)[:, 0]


def device_survival(X_all, F_all, n_survive: int, unit_refs, key,
                    mesh=None):
    """NSGA-III environmental selection, fully on device.

    Niche-filling follows pymoo's sequential semantics — repeatedly pick
    from the splitting front the candidate whose niche currently holds
    the fewest survivors (min-perpendicular-distance pick for empty
    niches, uniform random otherwise) — but is computed BATCHED via the
    water-filling identity: serving min-count niches one at a time is
    equivalent to raising a global fill level T, where niche j (initial
    count c_j, a_j candidates) absorbs k_j(T) = min(a_j, max(0, T-c_j))
    members. A 32-step binary search finds the level at which the front
    owes its last slot, the partial top level is ordered by per-niche
    min-nd (level 0) or uniformly at random (levels >=1), and the
    within-niche members are chosen by one segmented sort. This replaces
    the former `lax.while_loop` of ``need`` sequential O(Q) steps —
    1.66 s/generation at the north-star pop 10k worst case (everything
    rank 0), vs ~3 ms batched — with the identical survivor SET on the
    deterministic empty-niche path (pinned by
    tests/test_nsga_device.py::test_matches_host_when_deterministic).
    Returns (X, F, rank, niche, nd) of the survivors, ordered by front."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    Q = F_all.shape[0]
    R = unit_refs.shape[0]
    rank = device_nd_ranks(F_all, mesh=mesh)
    Fn = _device_normalize(F_all)
    niche, nd = _device_associate(Fn, unit_refs)

    # splitting front L: first rank whose cumulative count reaches the cap
    cnt = jnp.bincount(rank, length=Q)
    cum = jnp.cumsum(cnt)
    L = jnp.argmax(cum >= n_survive)
    n_before = jnp.where(L > 0, cum[jnp.maximum(L - 1, 0)], 0)
    need = n_survive - n_before
    keep = rank < L
    cand = rank == L

    counts = jnp.bincount(jnp.where(keep, niche, R), length=R + 1)[:R]
    avail = jnp.bincount(jnp.where(cand, niche, R), length=R + 1)[:R]

    # ---- water-filling level: minimal T with K(T) >= need -------------
    def K(t):
        return jnp.sum(jnp.minimum(avail, jnp.maximum(0, t - counts)))

    hi0 = jnp.max(counts) + jnp.asarray(Q + 1, counts.dtype)

    def bs_body(_, lo_hi):
        lo, hi = lo_hi
        mid = (lo + hi) // 2
        ge = K(mid) >= need
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    _, T = lax.fori_loop(0, 32, bs_body,
                         (jnp.zeros((), counts.dtype), hi0))

    # full levels below T-1, plus a partial pass at level T-1 that serves
    # only the first `rem` of the niches still holding candidates there
    k_full = jnp.minimum(avail, jnp.maximum(0, (T - 1) - counts))
    rem = need - jnp.sum(k_full)
    eligible = (counts <= T - 1) & (counts + avail > T - 1)

    key, k_n, k_c = jax.random.split(key, 3)
    idxs = jnp.arange(Q)
    ids = jnp.where(cand, niche, R)                  # candidates by niche
    niche_min_nd = jax.ops.segment_min(nd, ids, num_segments=R + 1)[:R]
    part_score = jnp.where(T == 1, niche_min_nd,
                           jax.random.uniform(k_n, (R,), nd.dtype))
    score = jnp.where(eligible, part_score, jnp.inf)
    niche_pos = jnp.argsort(jnp.argsort(score))
    k = k_full + (eligible & (niche_pos < rem)).astype(k_full.dtype)

    # within-niche members: the first pick from an initially-empty niche
    # is its min-nd candidate (priority -1); the rest are uniform random
    first_idx = jax.ops.segment_min(
        jnp.where(cand & (nd == niche_min_nd[niche]), idxs, Q),
        ids, num_segments=R + 1)[:R]
    is_first = cand & (idxs == first_idx[niche])
    prio = jnp.where(is_first & (counts[niche] == 0),
                     jnp.asarray(-1.0, nd.dtype),
                     jax.random.uniform(k_c, (Q,), nd.dtype))
    order_c = jnp.lexsort((prio, ids))               # non-candidates last
    ids_s = ids[order_c]
    starts = jnp.searchsorted(ids_s, jnp.arange(R + 1))
    pos_in = idxs - starts[ids_s]
    k_pad = jnp.concatenate([k, jnp.zeros(1, k.dtype)])
    sel_s = (ids_s < R) & (pos_in < k_pad[ids_s])
    selected = jnp.zeros(Q, bool).at[order_c].set(sel_s)
    keep_all = keep | selected
    order = jnp.argsort(jnp.where(keep_all, rank, Q + 1), stable=True)
    idx = order[:n_survive]
    return X_all[idx], F_all[idx], rank[idx], niche[idx], nd[idx]


def device_crowding(F, rank):
    """NSGA-II crowding distance on device, fronts defined by ``rank``.

    Host semantics (:func:`nsga.crowding_distance` applied per front):
    per objective, front members sorted by value; boundary members get
    inf, interior members accumulate (next - prev) / (front max - min).
    Vectorized over ALL fronts at once: one lexsort by (rank, f_j) per
    objective + segment min/max for the front spans."""
    import jax
    import jax.numpy as jnp

    Q, m = F.shape
    crowd = jnp.zeros(Q, F.dtype)
    for j in range(m):
        fj = F[:, j]
        order = jnp.lexsort((fj, rank))          # rank primary, f_j inside
        r_s = rank[order]
        f_s = fj[order]
        fmin = jax.ops.segment_min(fj, rank, num_segments=Q)
        fmax = jax.ops.segment_max(fj, rank, num_segments=Q)
        span_s = (fmax - fmin)[r_s]
        prev_same = jnp.concatenate([jnp.zeros(1, bool),
                                     r_s[1:] == r_s[:-1]])
        next_same = jnp.concatenate([r_s[:-1] == r_s[1:],
                                     jnp.zeros(1, bool)])
        interior = prev_same & next_same
        gap = jnp.roll(f_s, -1) - jnp.roll(f_s, 1)
        contrib = jnp.where(span_s > 0,
                            gap / jnp.where(span_s > 0, span_s, 1.0), 0.0)
        c_s = jnp.where(interior, contrib, jnp.inf)
        crowd = crowd.at[order].add(c_s)         # inf-dominant accumulation
    return crowd


def device_nsga2_survival(X_all, F_all, n_survive: int, mesh=None):
    """NSGA-II environmental selection on device: (rank asc, crowd desc).

    Matches :func:`nsga.nsga2_survival` semantics; picks among
    equal-(rank, crowd) members may differ by sort order."""
    import jax.numpy as jnp

    rank = device_nd_ranks(F_all, mesh=mesh)
    crowd = device_crowding(F_all, rank)
    order = jnp.lexsort((-crowd, rank))          # rank primary, crowd desc
    idx = order[:n_survive]
    return X_all[idx], F_all[idx], rank[idx], crowd[idx]


def run_nsga2_device(pop_objective, xl, xu, *, pop_size: int = 100,
                     n_gen: int = 100, seed: int = 42,
                     sbx_prob=0.9, sbx_eta=15.0, pm_eta=20.0,
                     constraint_fn=None, repair_fn=None,
                     x0: np.ndarray | None = None,
                     gens_per_block: int = 10,
                     callback=None, mesh=None) -> MOOResult:
    """NSGA-II with the entire generation loop on device.

    Drop-in for :func:`nsga.run_nsga2` on population-native jax
    objectives. ``repair_fn``/``constraint_fn`` must be jax-traceable
    ((P, n) -> (P, n) / (P, n_con)); constraint violations are penalized
    feasibility-first (1e6 x total violation), as on the host."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from phoskintime_tpu.config.numerics import working_dtype

    f32 = jnp.float64 if working_dtype() == np.float64 else jnp.float32
    rng = np.random.default_rng(seed)
    xl = np.asarray(xl, float)
    xu = np.asarray(xu, float)
    n_var = len(xl)
    bl = jnp.asarray(xl, f32)
    bu = jnp.asarray(xu, f32)

    def eval_all(Xb):
        F = pop_objective(Xb)
        if constraint_fn is not None:
            G = constraint_fn(Xb)
            F = F + 1e6 * jnp.sum(jnp.maximum(G, 0.0), axis=1)[:, None]
        return F

    def block(X, F, rank, crowd, key):
        def gen_step(carry, key):
            X, F, rank, crowd = carry
            kv, _ = jax.random.split(key)
            off = variation_kernel(X, rank, -crowd, kv, bl, bu,
                                   pop_size=pop_size, n_var=n_var,
                                   sbx_prob=sbx_prob, sbx_eta=sbx_eta,
                                   pm_eta=pm_eta)
            if repair_fn is not None:
                off = repair_fn(off)
            F_off = eval_all(off)
            X2 = jnp.concatenate([X, off])
            F2 = jnp.concatenate([F, F_off])
            X, F, rank, crowd = device_nsga2_survival(X2, F2, pop_size,
                                                      mesh=mesh)
            return (X, F, rank, crowd), (jnp.min(F, axis=0),
                                         jnp.mean(F, axis=0))

        keys = jax.random.split(key, gens_per_block)
        carry, (ideals, means) = lax.scan(gen_step, (X, F, rank, crowd),
                                          keys)
        return (*carry, ideals, means)

    def init(X0):
        X0 = jnp.asarray(X0, f32)
        if repair_fn is not None:
            X0 = repair_fn(X0)
        return device_nsga2_survival(X0, eval_all(X0), pop_size, mesh=mesh)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = int(np.prod(list(mesh.shape.values())))
        if pop_size % n_dev:
            raise ValueError(
                f"device NSGA-II: pop_size ({pop_size}) must be a "
                f"multiple of the mesh size ({n_dev})")
        row = NamedSharding(mesh, P("pop"))
        mat = NamedSharding(mesh, P("pop", None))
        rep = NamedSharding(mesh, P())
        carry_shard = (mat, mat, row, row)
        block_jit = sharded_jit(block, mesh,
                                in_shardings=(*carry_shard, rep),
                                out_shardings=(*carry_shard, rep, rep))
        init_jit = sharded_jit(init, mesh, out_shardings=carry_shard)
    else:
        block_jit = jax.jit(block)
        init_jit = jax.jit(init)

    X0 = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
    X, F, rank, crowd = init_jit(X0)
    n_evals = pop_size
    history: list = []
    gen = 0
    while gen < n_gen:
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31 - 1)))
        X, F, rank, crowd, ideals, means = block_jit(X, F, rank, crowd, key)
        ideals = np.asarray(ideals, float)
        means = np.asarray(means, float)
        for g in range(gens_per_block):
            gen += 1
            n_evals += pop_size
            history.append((gen, ideals[g].copy(), means[g].copy()))
        if callback is not None:
            callback(gen, np.asarray(X, float), np.asarray(F, float))

    X = np.asarray(X, float)
    F = np.asarray(F, float)
    pf = fast_non_dominated_sort(F)[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)


# ---------------------------------------------------------------------------
# the block loop
# ---------------------------------------------------------------------------

def make_device_ga_blocks(pop_objective, n_var: int, pop_size: int, *,
                          n_obj: int = 3, n_partitions: int = 20,
                          sbx_prob=0.9, sbx_eta=15.0, pm_eta=10.0,
                          gens_per_block: int = 10, mesh=None):
    """Build (init_fn, block_fn) for the all-device GA.

    init_fn(X0) -> carry: evaluates the initial population and computes
    its (rank, niche, nd) on device.
    block_fn(*carry, key, bl, bu) -> (*carry, ideals, means): `lax.scan`
    over ``gens_per_block`` full generations; ideals/means are the
    (gens_per_block, n_obj) per-generation history (the only data that
    crosses back to the host). The bounds are TRACED arguments, so
    refinement rounds with zoomed boxes reuse the compiled program.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from phoskintime_tpu.config.numerics import working_dtype

    # f32 GA state in production; explicit-f64 runs (PHOSKINTIME_DTYPE /
    # x64 parity mode) keep f64 so precision comparisons stay clean
    f32 = jnp.float64 if working_dtype() == np.float64 else jnp.float32
    refs = das_dennis(n_obj, n_partitions)
    unit = jnp.asarray(refs / np.linalg.norm(refs, axis=1, keepdims=True),
                       f32)

    def block(X, F, rank, niche, nd, key, bl, bu):
        def gen_step(carry, key):
            X, F, rank, niche, nd = carry
            kv, ks = jax.random.split(key)
            off = variation_kernel(X, rank, nd, kv, bl, bu,
                                   pop_size=pop_size, n_var=n_var,
                                   sbx_prob=sbx_prob, sbx_eta=sbx_eta,
                                   pm_eta=pm_eta)
            F_off = pop_objective(off)
            X2 = jnp.concatenate([X, off])
            F2 = jnp.concatenate([F, F_off])
            X, F, rank, niche, nd = device_survival(X2, F2, pop_size, unit,
                                                    ks, mesh=mesh)
            return (X, F, rank, niche, nd), (jnp.min(F, axis=0),
                                             jnp.mean(F, axis=0))

        keys = jax.random.split(key, gens_per_block)
        carry, (ideals, means) = lax.scan(gen_step, (X, F, rank, niche, nd),
                                          keys)
        return (*carry, ideals, means)

    def init(X0):
        X0 = jnp.asarray(X0, f32)
        F0 = pop_objective(X0)
        # survival over the initial pop itself (keeps everything) computes
        # rank/niche/nd in one pass with the same machinery
        key = jax.random.PRNGKey(0)
        return device_survival(X0, F0, pop_size, unit, key, mesh=mesh)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = int(np.prod(list(mesh.shape.values())))
        if pop_size % n_dev:
            raise ValueError(
                f"all-device GA loop: pop_size ({pop_size}) must be a "
                f"multiple of the mesh size ({n_dev}) — the population "
                f"stays sharded across generations, so transparent "
                f"padding would inject clone lanes into survival; use "
                f"pop_size={-(-pop_size // n_dev) * n_dev}")
        row = NamedSharding(mesh, P("pop"))
        mat = NamedSharding(mesh, P("pop", None))
        rep = NamedSharding(mesh, P())
        carry_shard = (mat, mat, row, row, row)
        block_jit = sharded_jit(block, mesh,
                                in_shardings=(*carry_shard, rep, rep, rep),
                                out_shardings=(*carry_shard, rep, rep))
        init_jit = sharded_jit(init, mesh, out_shardings=carry_shard)
    else:
        block_jit = jax.jit(block)
        init_jit = jax.jit(init)

    return init_jit, block_jit, f32


def run_unsga3_device(pop_objective, xl, xu, *, pop_size: int = 300,
                      n_gen: int = 100, n_obj: int = 3,
                      n_partitions: int = 20, seed: int = 42,
                      sbx_prob=0.9, sbx_eta=15.0, pm_eta=10.0,
                      ftol: float = 0.0025, ftol_period: int = 30,
                      n_max_evals: int | None = 100_000,
                      x0: np.ndarray | None = None,
                      gens_per_block: int = 10,
                      callback=None, logger=None, mesh=None,
                      prebuilt=None) -> MOOResult:
    """U-NSGA-III with the ENTIRE generation loop on device.

    Drop-in for :func:`nsga.run_unsga3` on population-native objectives:
    same operator/survival semantics, jax RNG stream, and the host only
    touches the per-generation ideal/mean history between blocks of
    ``gens_per_block`` generations (ftol window, n_max_evals cap and the
    checkpoint/pruning callback run at block granularity — the callback
    sees the device-resident population only when it fires).

    prebuilt: (init_fn, block_fn, dtype) from
    :func:`make_device_ga_blocks` — pass the same tuple across calls
    (e.g. refinement rounds with zoomed bounds) to reuse the compiled
    programs; the bounds are traced arguments of the block.
    """
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    xl = np.asarray(xl, float)
    xu = np.asarray(xu, float)
    X0 = lhs_sampling(pop_size, xl, xu, rng) if x0 is None else np.array(x0)
    if x0 is not None and len(X0) < pop_size:
        X0 = np.vstack([X0, lhs_sampling(pop_size - len(X0), xl, xu, rng)])

    init_fn, block_fn, f32 = prebuilt if prebuilt is not None else \
        make_device_ga_blocks(
            pop_objective, len(xl), pop_size, n_obj=n_obj,
            n_partitions=n_partitions, sbx_prob=sbx_prob, sbx_eta=sbx_eta,
            pm_eta=pm_eta, gens_per_block=gens_per_block, mesh=mesh)
    bl = jnp.asarray(xl, f32)
    bu = jnp.asarray(xu, f32)

    X, F, rank, niche, nd = init_fn(X0)
    n_evals = pop_size
    history: list = []
    ideal_history = [np.asarray(F.min(axis=0), float)]
    gen = 0
    stop = False
    while gen < n_gen and not stop:
        key = jax.random.PRNGKey(int(rng.integers(2 ** 31 - 1)))
        X, F, rank, niche, nd, ideals, means = block_fn(
            X, F, rank, niche, nd, key, bl, bu)
        ideals = np.asarray(ideals, float)
        means = np.asarray(means, float)
        for g in range(gens_per_block):
            gen += 1
            n_evals += pop_size
            history.append((gen, ideals[g].copy(), means[g].copy()))
            ideal_history.append(ideals[g])
        if callback is not None and callback(gen, np.asarray(X, float),
                                             np.asarray(F, float)):
            stop = True
        if logger is not None:
            logger.info(f"[UNSGA3/device] gen {gen}: ideal={ideals[-1]}")
        # same sliding-window termination as the host loop, checked on the
        # exact per-generation ideal history (block granularity only
        # bounds HOW LATE we can stop, not the window arithmetic)
        if len(ideal_history) > ftol_period:
            prev = ideal_history[-ftol_period - 1]
            cur = ideal_history[-1]
            denom = np.maximum(np.abs(prev), 1e-12)
            if np.max(np.abs(cur - prev) / denom) < ftol:
                stop = True
        if n_max_evals is not None and n_evals >= n_max_evals:
            stop = True

    X = np.asarray(X, float)
    F = np.asarray(F, float)
    pf = fast_non_dominated_sort(F)[0]
    return MOOResult(X, F, X[pf], F[pf], history, gen, n_evals)
