"""Partial refresh: power-iteration sweeps restricted to the dirty
frontier plus its fan-in.

A host-only copy of ``protocol_tpu/incremental/partial.py`` (numpy, no
device), kept line for line so the two packages' partial sweeps give
the same bits.

The footing ("Analysis of Power Iteration Algorithm with Partially
Observed Matrix-vector Products", PAPERS.md): when only a small slice
of the opinion matrix changed, the published vector is a near-fixed-
point of the new operator *except on the nodes downstream of the dirty
rows*. A full sweep would recompute every coordinate only to reproduce
the old value almost everywhere; the partial sweep recomputes exactly
the coordinates whose inputs changed and propagates outward along
fan-out edges, so a churn window costs O(dirty · degree) host numpy
instead of an O(E) device matvec — and O(dirty) is precisely what the
delta engine already tracks.

One term is genuinely global: the dangling-mass rank-1 correction adds
``d_mass / (n_valid − 1)`` to every valid coordinate, so a change in
``d_mass`` shifts ALL of them uniformly. The sweep tracks that shift
as a lazily-materialized scalar (``uni``) — O(1) per sweep — rather
than exploding the frontier to the whole graph. The shift's own
*onward propagation* through the matrix is the one thing the partial
sweep does not compute; since a uniform perturbation of L1 mass
``|g|·n_valid`` stays L1-non-expanding under the mass-conserving
operator, the accumulated ``Σ|g|·n_valid`` is an upper bound on the
neglected error, and blowing a ``tol``-sized budget of it falls back
to the full sweep. On the dominant churn shape — weight revisions
with a stable dangling set — every ``g`` is exactly zero and the
sweeps are exact. The damping term (α > 0) needs no tracking at all:
total mass is conserved by the operator, so ``α·p·total`` is constant
per coordinate.

Honesty bounds (all degrading down the ladder — the sampled mode, then
a FULL device sweep on the patched operator — still zero plan
rebuilds):

- the frontier outgrowing ``frontier_limit`` (propagation reached too
  much of the graph for partial to win);
- failing to reach ``tol`` within ``max_sweeps``;
- the accumulated L1 honesty budget (``max(tol, error_budget)``)
  exhausted by the uniform-shift drift plus the priced truncation of
  sub-``drop_eps`` expansion (see :func:`external_out_weight`);
- a peer-set change since publish (the warm vector is then not a
  near-fixed-point anywhere — the engine reports ``partial_ok=False``).

The reported residual has full-sweep semantics: the L1 change of the
COMPLETE vector per sweep (frontier exact part + the uniform shift on
everyone else) over the warm-start norm — directly comparable to the
device ``adaptive_loop`` residual, which the parity test asserts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .engine import expand_csr


@dataclass
class PartialResult:
    scores: np.ndarray   # node order, float64
    sweeps: int
    residual: float
    frontier_peak: int   # widest frontier reached (observability)
    # accumulated relative-L1 honesty-budget spend: the uniform-shift
    # propagation bound, plus (sampled mode) the neglected-propagation
    # mass bound — the declared error vs a full-sweep oracle
    budget_spent: float = 0.0
    # sampled mode: how many sweeps redrew a DIFFERENT observation set
    # (the per-sweep Gumbel-top-k resampling of arXiv 2606.11956 —
    # 0 when the closure fits the budget whole, so every draw is the
    # same set, or in the partial/device_partial modes)
    resamples: int = 0


def as_frontier_array(frontier) -> np.ndarray:
    """Sorted unique int64 frontier. The engine (and the ladder, which
    normalizes once and hands the same array to each rung) pass an
    already-canonical array — detected with one vectorized
    monotonicity pass, no re-sort; legacy set/iterable callers pay one
    conversion — never a per-element ``int()`` loop over an ndarray."""
    if isinstance(frontier, np.ndarray):
        f = frontier.astype(np.int64, copy=False)
        if len(f) < 2 or bool(np.all(f[1:] > f[:-1])):
            return f
    else:
        f = np.fromiter((int(x) for x in frontier), dtype=np.int64,
                        count=len(frontier))
    return np.unique(f)


def frontier_inedges(eng, F: np.ndarray):
    """The frontier's gathered in-edge segments ``(rows, srcs, w)``:
    entry k is an in-edge of frontier row ``F[rows[k]]`` from node
    ``srcs[k]`` with TRUE current normalized weight
    ``w[k] = raw/row_sum_now`` (removed edges carry raw 0 and vanish).
    Built CSR + overflow tail; the one gather both the host partial
    sweep (bincount reduction) and the device kernel
    (``ops.converge.partial_sweep_device``) consume, so their operand
    semantics cannot drift."""
    rows_parts: list = []
    src_parts: list = []
    w_parts: list = []
    Fb = F[F < eng.n0]
    if len(Fb):
        rows, pos = expand_csr(eng.in_ptr, Fb)
        total = len(pos)
        if total:
            eids = eng.in_order[pos]
            srcs = eng.fsrc[eids]
            denom = eng.row_sum_now[srcs]
            w = np.divide(eng.raw_val[eids], denom,
                          out=np.zeros(total), where=denom > 0)
            # Fb is a prefix-filtered subset of the sorted F: map back
            rows_parts.append(np.searchsorted(F, Fb)[rows])
            src_parts.append(srcs)
            w_parts.append(w)
    t_rows, t_tis = _tail_inedges(eng, F)
    if len(t_tis):
        tsrc = eng.tail_src_np[t_tis]
        denom = eng.row_sum_now[tsrc]
        w = np.divide(eng.tail_raw_np[t_tis], denom,
                      out=np.zeros(len(t_tis)), where=denom > 0)
        rows_parts.append(t_rows)
        src_parts.append(tsrc)
        w_parts.append(w)
    if not rows_parts:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0)
    return (np.concatenate(rows_parts), np.concatenate(src_parts),
            np.concatenate(w_parts))


def _fanin(eng, F: np.ndarray, s: np.ndarray):
    """(base, in_wsum) over the frontier: Σ w·s[src] and Σ w per
    frontier node, reduced from the shared in-edge gather."""
    rows, srcs, w = frontier_inedges(eng, F)
    if not len(rows):
        return np.zeros(len(F)), np.zeros(len(F))
    base = np.bincount(rows, weights=w * s[srcs], minlength=len(F))
    in_wsum = np.bincount(rows, weights=w, minlength=len(F))
    return base, in_wsum


def _member_pos(sorted_arr: np.ndarray, values: np.ndarray):
    """(membership mask, insertion positions) of ``values`` against a
    sorted unique array — the positions double as indexes into
    ``sorted_arr`` wherever the mask is set."""
    if not len(sorted_arr):
        z = np.zeros(len(values), dtype=np.int64)
        return np.zeros(len(values), dtype=bool), z
    pos = np.searchsorted(sorted_arr, values)
    hit = ((pos < len(sorted_arr))
           & (sorted_arr[np.minimum(pos, len(sorted_arr) - 1)]
              == values))
    return hit, pos


def _member(sorted_arr: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Boolean membership of ``values`` in a sorted unique array."""
    return _member_pos(sorted_arr, values)[0]


def _tail_outedges(eng, S: np.ndarray):
    """(rows, tail positions) of live tail edges OUT of ``S`` — the
    src-side twin of :func:`_tail_inedges`, same hybrid rule."""
    z = np.zeros(0, dtype=np.int64)
    if not eng.tail_by_src:
        return z, z
    if len(S) * 4 < len(eng.tail_raw_np):
        rows_list: list = []
        pos_list: list = []
        for r, u in enumerate(S.tolist()):
            for ti in eng.tail_by_src.get(u, ()):
                if eng.tail_raw_np[ti] > 0:
                    rows_list.append(r)
                    pos_list.append(ti)
        eng.tail_fanout_visited += len(pos_list)
        return (np.asarray(rows_list, dtype=np.int64),
                np.asarray(pos_list, dtype=np.int64))
    live = eng.tail_raw_np > 0
    tsrc = eng.tail_src_np[live]
    hit = _member(S, tsrc)
    eng.tail_fanout_visited += int(live.sum())
    return (np.searchsorted(S, tsrc[hit]),
            np.nonzero(live)[0][hit])


def external_out_weight_rows(eng, S: np.ndarray,
                             R: np.ndarray) -> np.ndarray:
    """Per-row external out-weight of ``R`` (sorted, ⊆ ``S``) against
    the membership set ``S``: for each r in R, the sum of r's TRUE
    normalized out-edge weights whose destination lies OUTSIDE S — the
    multiplier that prices a row's per-sweep change into
    neglected-propagation L1 mass (the operator is row-stochastic, so
    a |Δr| change leaks at most |Δr|·ext_w(r) of L1 outside the
    observed set per sweep). The observation-error term of the
    partially-observed power-iteration footing (PAPERS.md, arXiv
    2606.11956), charged to the honesty budget by both the
    truncated-expansion partial sweeps and the fixed-set sampled mode.

    Splitting the row set from the membership set is what makes
    frontier expansions sublinear in frontier size: only the APPENDED
    rows pay an out-edge walk (``R=new``), while existing rows update
    by subtraction (:func:`expand_out_weight`). Cost: O(Σ out-degree
    of R); ``eng.ext_weight_rows_computed`` counts the rows walked —
    the regression signal that expansions stopped recomputing the
    whole frontier."""
    eng.ext_weight_rows_computed = getattr(
        eng, "ext_weight_rows_computed", 0) + int(len(R))
    ext = np.zeros(len(R))
    Rb = R[R < eng.n0]
    if len(Rb):
        rows, pos = expand_csr(eng.out_ptr, Rb)
        if len(pos):
            src = Rb[rows]
            denom = eng.row_sum_now[src]
            w = np.divide(eng.raw_val[pos], denom,
                          out=np.zeros(len(pos)), where=denom > 0)
            outside = ~_member(S, eng.fdst[pos])
            ext_b = np.bincount(rows, weights=w * outside,
                                minlength=len(Rb))
            ext[np.searchsorted(R, Rb)] += ext_b
    rows2, tis = _tail_outedges(eng, R)
    if len(tis):
        tsrc = eng.tail_src_np[tis]
        denom = eng.row_sum_now[tsrc]
        w = np.divide(eng.tail_raw_np[tis], denom,
                      out=np.zeros(len(tis)), where=denom > 0)
        outside = ~_member(S, eng.tail_dst_np[tis])
        np.add.at(ext, rows2, w * outside)
    return ext


def external_out_weight(eng, S: np.ndarray) -> np.ndarray:
    """Full-set form: every row of ``S`` against ``S`` (the from-
    scratch computation; expansions use the incremental pair
    :func:`external_out_weight_rows` + :func:`expand_out_weight`)."""
    return external_out_weight_rows(eng, S, S)


def expand_out_weight(eng, S_old: np.ndarray, ext_old: np.ndarray,
                      new_rows: np.ndarray, in_edges=None) -> tuple:
    """Incremental ext-weight maintenance across a frontier expansion
    (the ROADMAP 3 residual): ``S_new = S_old ∪ new_rows`` changes
    per-row external out-weight in exactly two places —

    - **appended rows** need a fresh walk of THEIR out-edges
      (``external_out_weight_rows(eng, S_new, new_rows)``);
    - **boundary-crossing rows** — existing rows with an out-edge INTO
      a newly-observed row — lose that edge's weight from their
      external sum (the destination moved inside the set). Those edges
      are precisely the in-edges of ``new_rows``, which the caller
      usually ALREADY gathered to build the expansion's operands —
      pass them as ``in_edges=(rows, srcs, w)`` to avoid a second
      gather.

    Everything else is untouched, so an expansion costs O(new rows'
    degree), not O(frontier fan-out). Returns ``(S_new, ext_new)``
    with ``ext_new`` aligned to the sorted ``S_new``. ``new_rows``
    must be sorted and disjoint from ``S_old`` (the caller's
    ``~_member`` filter guarantees it)."""
    if in_edges is None:
        in_edges = frontier_inedges(eng, new_rows)
    rows, srcs, w = in_edges
    ext_dec = ext_old.copy()
    if len(srcs):
        hit, pos = _member_pos(S_old, srcs)
        if hit.any():
            np.subtract.at(ext_dec, pos[hit], w[hit])
            # float dust: a fully-interior row's sum telescopes to 0
            np.maximum(ext_dec, 0.0, out=ext_dec)
    ins = np.searchsorted(S_old, new_rows)
    S_new = np.insert(S_old, ins, new_rows)
    ext_new_rows = external_out_weight_rows(eng, S_new, new_rows)
    ext_new = np.insert(ext_dec, ins, ext_new_rows)
    return S_new, ext_new


def _tail_inedges(eng, F: np.ndarray):
    """(rows, tail positions) of live tail edges INTO the frontier.

    Per-row tail index: visit only the tail edges INTO the frontier —
    O(|F| + hits) dict lookups, NOT a linear pass over the whole tail
    per sweep (which dominated every churn batch past ~10^4 tail
    edges). Dead entries (raw 0 after a removal) are skipped at use;
    the index itself only grows until the next re-anchor. Hybrid: once
    the frontier rivals the tail, the interpreter-level walk loses to
    one vectorized C-speed pass over the whole tail — fall back to the
    scan there."""
    z = np.zeros(0, dtype=np.int64)
    if not eng.tail_by_dst:
        return z, z
    if len(F) * 4 < len(eng.tail_raw_np):
        rows_list: list = []
        pos_list: list = []
        for r, u in enumerate(F.tolist()):
            for ti in eng.tail_by_dst.get(u, ()):
                if eng.tail_raw_np[ti] > 0:
                    rows_list.append(r)
                    pos_list.append(ti)
        eng.tail_fanin_visited += len(pos_list)
        tis = np.asarray(pos_list, dtype=np.int64)
        rows = np.asarray(rows_list, dtype=np.int64)
    else:
        live = eng.tail_raw_np > 0
        tdst = eng.tail_dst_np[live]
        hit, pos = _member_pos(F, tdst)
        tis = np.nonzero(live)[0][hit]
        rows = pos[hit]
        # the counter tracks entries EXAMINED (the regression
        # test's signal), and this branch scanned every live one
        eng.tail_fanin_visited += int(live.sum())
    return rows, tis


def _fanout(eng, nodes: np.ndarray) -> np.ndarray:
    """Out-neighbors of ``nodes`` (built CSR + tail), unique. The tail
    side walks the per-src index (O(adjacent tail edges)) — the
    ``np.isin`` scan it replaces re-read the whole tail per sweep."""
    parts = []
    nb = nodes[nodes < eng.n0]
    if len(nb):
        _, pos = expand_csr(eng.out_ptr, nb)
        if len(pos):
            parts.append(eng.fdst[pos])
    if eng.tail_by_src:
        # same hybrid rule as _fanin: indexed walk while the node set
        # is small relative to the tail, vectorized scan past it
        if len(nodes) * 4 < len(eng.tail_raw_np):
            dsts: list = []
            for u in nodes.tolist():
                for ti in eng.tail_by_src.get(u, ()):
                    if eng.tail_raw_np[ti] > 0:
                        dsts.append(int(eng.tail_dst_np[ti]))
            eng.tail_fanout_visited += len(dsts)
            if dsts:
                parts.append(np.asarray(dsts, dtype=np.int64))
        else:
            m = (eng.tail_raw_np > 0) & np.isin(eng.tail_src_np, nodes)
            # examined the whole tail, not just the matches
            eng.tail_fanout_visited += len(eng.tail_raw_np)
            if m.any():
                parts.append(eng.tail_dst_np[m])
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(parts))


def partial_refresh(eng, s0, frontier, tol: float, max_sweeps: int,
                    frontier_limit: int, error_budget: float = 0.0
                    ) -> PartialResult | None:
    """Frontier-restricted sweeps from ``s0`` (node order, the warm
    vector); ``frontier`` is the engine's dirty set (nodes whose
    fan-in changed since publish). ``error_budget`` (relative L1, 0 =
    exact mode: the budget is ``tol``) prices truncated expansion —
    see the drop_eps comment below. None = no footing / out of
    budget — degrade down the ladder (sampled, then a full sweep)."""
    n = eng.n_now
    valid = eng.valid_np.astype(np.float64)
    dangling = eng.dangling_np.astype(np.float64)
    n_valid = float(eng.n_valid)
    denom = max(n_valid - 1.0, 1.0)
    alpha = eng.alpha
    keep = 1.0 - alpha

    s = np.asarray(s0, dtype=np.float64).copy()
    if s.shape != (n,):
        return None
    norm = max(float(np.sum(np.abs(s))), 1.0)
    total = float(np.sum(s * valid))   # conserved by the operator
    uni = 0.0                          # pending uniform add on valid
    d_arr = float(np.sum(s * dangling))
    dang_count = float(dangling.sum())
    d_prev = d_arr                     # d_mass of the previous iterate

    # the engine hands the frontier over as a sorted int64 ndarray —
    # O(1) here; a per-element int() loop at 10^5+ dirty nodes was the
    # old interpreter-bound materialization
    F = as_frontier_array(frontier)
    F = F[(F >= 0) & (F < n)]
    if not len(F):
        return PartialResult(s, 0, 0.0, 0)

    peak = len(F)
    residual = np.inf
    budget = max(tol, error_budget)
    uni_budget = 0.0   # L1 bound on neglected uniform-shift propagation
    negl_budget = 0.0  # L1 bound on neglected truncated expansion
    ext = None         # external out-weights of F (refreshed on growth)
    # expansion threshold: changes this small may skip fan-out — the
    # L1 mass their skip can leak outside the frontier (|Δ|·ext_w, the
    # partially-observed observation-error term) is CHARGED to the
    # honesty budget below, so truncation is priced, never silent.
    # error_budget > tol buys sublinear frontiers on small-world
    # graphs, where the exact influence region of any churn floods the
    # whole graph at tol-level thresholds.
    drop_eps = 0.25 * budget * norm / max(n_valid, 1.0)
    for sweep in range(1, max_sweeps + 1):
        if len(F) > frontier_limit:
            return None
        peak = max(peak, len(F))
        d_now = d_arr + uni * dang_count
        g = keep * (d_now - d_prev) / denom  # uniform shift this sweep
        d_prev = d_now
        base, in_wsum = _fanin(eng, F, s)
        base_true = base + uni * in_wsum  # all srcs valid: s_true=s+uni
        s_true_F = s[F] + uni * valid[F]
        corr = (d_now - dangling[F] * s_true_F) / denom
        new_true = base_true + corr * valid[F]
        if alpha:
            new_true = keep * new_true + alpha * (
                valid[F] / max(n_valid, 1.0)) * total
        uni += g
        uni_budget += abs(g) * n_valid / norm
        if uni_budget + negl_budget > budget:
            return None  # dangling mass drifted too far for partial
        # store representation: true = s + uni*valid
        old_arr = s[F].copy()
        s[F] = new_true - uni * valid[F]
        d_arr += float(np.sum(dangling[F] * (s[F] - old_arr)))
        # full-vector per-sweep L1 change: exact on the frontier,
        # uniform |g| on every other valid coordinate
        changed = new_true - s_true_F
        l1 = float(np.sum(np.abs(changed))) + abs(g) * max(
            n_valid - float(valid[F].sum()), 0.0)
        residual = l1 / norm
        if residual <= tol:
            break
        big = np.abs(changed) > drop_eps
        if ext is None:
            ext = external_out_weight(eng, F)
        # skipped rows: their un-expanded fan-out leaks ≤ |Δ|·ext_w of
        # L1 outside F this sweep (expanded rows' propagation is only
        # DELAYED — their fan-out joins F and reads the updated score)
        negl_budget += float(
            np.sum(np.abs(changed[~big]) * ext[~big])) / norm
        if uni_budget + negl_budget > budget:
            return None  # truncated-expansion budget exhausted
        moved = F[big]
        if len(moved):
            grown = _fanout(eng, moved)
            new = grown[~_member(F, grown)]
            if len(new):
                # incremental ext-weight maintenance: fresh walk for
                # the appended rows only, subtraction for the
                # boundary-crossing ones — never a whole-frontier
                # recompute per expansion (ext is non-None here: the
                # pricing above always materializes it first)
                F, ext = expand_out_weight(eng, F, ext, new)
    else:
        return None
    if uni != 0.0:
        s = s + uni * valid
    return PartialResult(s, sweep, residual, peak,
                         budget_spent=uni_budget + negl_budget)
