"""Device partial sweeps and partially-observed (sampled) refreshes.

The port of ``protocol_tpu/incremental/device.py``, on torch. The device
sweeps run in the engine's ``dtype`` on its ``device`` (the reference
takes JAX's default float, f64 under x64 and f32 otherwise; here the
engine names it), and every tensor they update is written in place.

``partial.py`` runs the frontier-restricted power iteration in host
numpy — right for tiny frontiers, interpreter- and bandwidth-bound past
~10^4 dirty rows. This module moves the same math onto the device and
adds the mode between "partial" and "full":

- :func:`device_partial_refresh` — the host partial sweep's device
  twin: per sweep the frontier's in-edge segments (built-CSR slices +
  the per-row COO tail indexes) are gathered host-side and reduced
  by ``ops.converge.partial_sweep_device``; the score vector
  stays device-resident across sweeps and the dangling-mass rank-1
  shift stays the O(1) host scalar ``partial.py`` tracks. Frontiers of
  10^4–10^6 rows run at O(frontier fan-in) instead of dropping to host
  numpy or a full O(E) sweep.

- :func:`sampled_refresh` — the partially-observed mode ("Analysis of
  Power Iteration Algorithm with Partially Observed Matrix-vector
  Products", PAPERS.md): when the frontier outgrows the partial bound,
  converge on a PER-SWEEP-RESAMPLED set S_t = frontier ∪
  importance-sampled fan-out closure (≤ ``sample_budget`` rows, Gumbel
  top-k on score mass — the heavy rows absorb most of the neglected
  L1; each sweep's draw is seeded per (refresh, sweep), so runs stay
  deterministic while long sampled streaks stop neglecting the same
  complement rows — the paper's per-iteration resampling). Rows
  outside the current S are not updated that sweep; what their
  staleness can cost is bounded
  exactly: a row r ∈ S that moved by |Δr| propagates at most
  |Δr| · ext_w(r) of L1 mass outside S per sweep (row-stochastic
  operator), where ext_w(r) is r's out-weight leaving S. That
  neglected-propagation mass is the paper's observation-error term,
  accumulated into the SAME relative-L1 honesty budget the partial
  sweep already keeps for the uniform dangling shift — blow the
  ``max(tol, error_budget)`` budget and the refresh falls back to the
  full device sweep. The accumulated spend is the FIRST-ORDER leak;
  once outside S the mass keeps propagating, so the end-to-end L1
  error vs a full sweep is bounded by the damped Neumann series —
  ``budget_spent / alpha`` — which is what benchmarks and tests
  declare and assert against.

- :func:`ladder_refresh` — the explicit sublinear ladder
  ``partial → device_partial → sampled``; the caller's remaining rungs
  are ``full`` (whole-operator device sweep) and ``rebuild``.

Everything here shares operand semantics with the host twin through
``partial.frontier_inedges`` and mirrors its per-sweep scalar math
exactly — the device-vs-host parity test in ``tests/test_sublinear.py``
pins that.
"""

from __future__ import annotations

import numpy as np

import torch

from ..utils import trace
from .partial import (
    PartialResult,
    _fanout,
    _member,
    _member_pos,
    as_frontier_array,
    external_out_weight,
    external_out_weight_rows,
    frontier_inedges,
    partial_refresh,
)


def _expand_ext_slots(eng, old_sorted, old_slots, ext, new_sorted,
                      new_rows, in_edges) -> np.ndarray:
    """Slot-ordered twin of ``partial.expand_out_weight``: the device
    operands keep ext in INSERTION (slot) order with appended rows at
    the end, so the boundary-crossing decrement maps each in-edge
    source through sorted-rank → slot index, and the fresh walk of the
    appended rows (against the EXPANDED membership) concatenates at
    the tail. O(new rows' degree + |frontier|) vectorized index work —
    never the O(frontier fan-out) whole-set recompute an expansion
    used to pay."""
    rows, srcs, w = in_edges
    ext = ext.copy()
    if len(srcs):
        hit, pos = _member_pos(old_sorted, srcs)
        if hit.any():
            inv = np.empty(len(old_slots), dtype=np.int64)
            inv[np.searchsorted(old_sorted, old_slots)] = \
                np.arange(len(old_slots))
            np.subtract.at(ext, inv[pos[hit]], w[hit])
            # float dust: a fully-interior row telescopes to 0
            np.maximum(ext, 0.0, out=ext)
    ext_new = external_out_weight_rows(eng, new_sorted, new_rows)
    return np.concatenate([ext, ext_new])


class _FrontierOperands:
    """Device operands for ``partial_sweep_device`` with INCREMENTAL
    append: one entry per frontier row and one per gathered in-edge,
    no padding (the reference pads to powers of two to bound its jit
    cache; eager torch has none).

    The append path is what makes the device_partial rung's dominant
    host cost sublinear in frontier size: a frontier expansion gathers
    the in-edges of ONLY the newly-added rows (``frontier_inedges``
    over the new rows, O(new fan-in)) and concatenates them onto the
    existing device tensors — the old per-expansion rebuild re-gathered
    and re-uploaded the WHOLE frontier every time, an O(frontier
    fan-in) host pass per expansion that dominated the rung's wall at
    10^5+ rows. Appended rows take slots AFTER the existing ones, so
    ``slots`` is insertion-ordered (sorted within each append batch)
    while ``sorted`` keeps the membership view; the kernel never cares
    about slot order, and the per-slot ``changed`` vector aligns with
    ``slots``. ``e_row`` is not sorted (tail in-edges follow the built
    ones, each append starts a new run), so the sweep's segment sums are
    ``ops.converge.scatter_sum``s, not sums over offsets.
    """

    def __init__(self, eng, F: np.ndarray, ext_w=None):
        self.eng = eng
        F = np.asarray(F, dtype=np.int64)
        self.slots = F            # slot -> node id (insertion order)
        self.sorted = F           # sorted membership view (F is sorted)
        self.gathered_rows = int(len(F))  # each row gathered ONCE —
        # the regression test's no-rebuild signal
        rows, srcs, w = frontier_inedges(eng, F)
        self.f_idx = eng.device_array(F, np.int64)
        self.f_valid = eng.device_array(eng.valid_np[F])
        self.f_dang = eng.device_array(eng.dangling_np[F])
        self.f_ext = eng.device_array(
            np.zeros(len(F)) if ext_w is None else ext_w)
        self.e_row = eng.device_array(rows, np.int64)
        self.e_src = eng.device_array(srcs, np.int64)
        self.e_w = eng.device_array(w)

    @property
    def n_f(self) -> int:
        return self.f_idx.shape[0]

    def arrays(self) -> tuple:
        return (self.f_idx, self.f_valid, self.f_dang, self.f_ext,
                self.e_row, self.e_src, self.e_w)

    def append(self, new_rows: np.ndarray):
        """Extend the frontier by ``new_rows`` (sorted, disjoint from
        the current set): gather ONLY their in-edges and append both
        row and edge operands on device. Returns the gathered
        ``(rows, srcs, w)`` triple — the caller's incremental
        ext-weight update needs exactly these edges (they are the
        boundary-crossing ones), so it must not gather them twice."""
        eng = self.eng
        new_rows = np.asarray(new_rows, dtype=np.int64)
        if not len(new_rows):
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0)
        self.gathered_rows += int(len(new_rows))
        rows, srcs, w = frontier_inedges(eng, new_rows)
        # f_ext stays 0: the expanding mode prices truncation on the
        # host; the fixed-set mode never appends
        for name, host, dtype in (
                ("f_idx", new_rows, np.int64),
                ("f_valid", eng.valid_np[new_rows], None),
                ("f_dang", eng.dangling_np[new_rows], None),
                ("f_ext", np.zeros(len(new_rows)), None),
                ("e_row", rows + self.n_f, np.int64),
                ("e_src", srcs, np.int64),
                ("e_w", w, None)):
            setattr(self, name, torch.cat(
                [getattr(self, name), eng.device_array(host, dtype)]))
        self.slots = np.concatenate([self.slots, new_rows])
        # linear merge of two sorted DISJOINT arrays — union1d's
        # concat-sort is O(F log F) per expansion for no reason
        pos = np.searchsorted(self.sorted, new_rows)
        self.sorted = np.insert(self.sorted, pos, new_rows)
        return rows, srcs, w


def _device_sweeps(eng, s0, F: np.ndarray, tol: float, max_sweeps: int,
                   frontier_limit: int | None, ext_w,
                   error_budget: float = 0.0,
                   resample=None) -> PartialResult | None:
    """The shared sweep driver: device kernel per sweep, host scalars
    for the dangling shift and the honesty budget — the exact per-sweep
    math of ``partial.partial_refresh`` (mirror changes both ways; the
    parity test catches drift).

    ``frontier_limit`` set: expanding-frontier (device-partial) mode —
    F grows along fan-out of moved rows (operands APPEND on device —
    only the new rows' in-edges are gathered, never the whole frontier
    again), declines past the limit, and truncated expansion (rows
    under drop_eps) is priced at |Δ|·ext_w against the budget, exactly
    like the host twin. ``frontier_limit`` None: fixed-set (sampled)
    mode — EVERY observed row's |Δ|·ext_w is charged (the complement
    never updates, so all boundary-crossing propagation is permanently
    neglected); when ``resample`` is given (``sweep -> sorted row
    set``), the observation set is REDRAWN before every sweep — the
    paper's per-iteration resampling, de-biasing which rows stay
    neglected over a long sampled streak — and the operands (and each
    row set's external out-weights) rebuild only on a draw that
    actually changed the set. The stopping residual is the
    observed-rows residual either way; the accumulated charge is
    reported as ``budget_spent``, the declared error vs a full
    sweep."""
    from ..ops.converge import partial_sweep_device

    n = eng.n_now
    valid = eng.valid_np.astype(np.float64)
    dangling = eng.dangling_np.astype(np.float64)
    n_valid = float(eng.n_valid)
    denom = max(n_valid - 1.0, 1.0)
    alpha = eng.alpha
    keep = 1.0 - alpha

    s = np.asarray(s0, dtype=np.float64)
    if s.shape != (n,):
        return None
    norm = max(float(np.sum(np.abs(s))), 1.0)
    total = float(np.sum(s * valid))
    uni = 0.0
    d_arr = float(np.sum(s * dangling))
    dang_count = float(dangling.sum())
    d_prev = d_arr

    if not len(F):
        return PartialResult(s.copy(), 0, 0.0, 0)

    # the sweeps write it in place: never the caller's array (on the
    # CPU a float64 ``device_array`` shares its memory)
    s_dev = eng.device_array(s).clone()
    expand = frontier_limit is not None
    # fixed-set mode: the kernel prices every row's external leak; the
    # expanding mode prices only truncated (sub-drop_eps) rows, on the
    # host, from the downloaded per-row changes
    ops = _FrontierOperands(eng, F, None if expand else ext_w)
    ext = None
    resamples = 0

    peak = len(F)
    residual = np.inf
    budget = max(tol, error_budget)
    # the kernel runs in the engine's dtype (f32 unless named), whose
    # relative-L1 residual plateaus near the dtype oscillation floor at
    # scale — a finer tol would burn max_sweeps
    # and decline every time. When the honesty budget can absorb the
    # coarser stop, clamp the stopping tol to the floor and charge the
    # slack like any other neglected term; when it cannot (exact
    # mode), keep the caller's tol — tiny graphs do reach an exact
    # f32 fixed point — and let the stall guard below decline fast.
    floor = _dtype_floor(eng)
    tol_slack = floor - tol if (tol < floor <= budget + tol) else 0.0
    eff_tol = tol + tol_slack
    uni_budget = 0.0
    negl_budget = 0.0
    drop_eps = 0.25 * budget * norm / max(n_valid, 1.0)
    best_residual = np.inf
    stalled = 0
    for sweep in range(1, max_sweeps + 1):
        if expand and ops.n_f > frontier_limit:
            return None
        if resample is not None and sweep > 1:
            # per-sweep resampling (sampled mode): a fresh Gumbel draw
            # picks this sweep's observation set; only an actually-
            # different set pays the operand + ext_w rebuild
            S_new = resample(sweep)
            if S_new is not None and not np.array_equal(S_new,
                                                        ops.sorted):
                ops = _FrontierOperands(
                    eng, S_new, external_out_weight(eng, S_new))
                resamples += 1
        peak = max(peak, ops.n_f)
        d_now = d_arr + uni * dang_count
        g = keep * (d_now - d_prev) / denom
        d_prev = d_now
        uni_next = uni + g
        scal = eng.device_array(np.array([uni, uni_next, d_now, denom,
                                          keep, alpha, n_valid, total]))
        s_dev, changed, l1, d_delta, vsum, negl = partial_sweep_device(
            s_dev, *ops.arrays(), scal)
        # the host scalars of this sweep, in one device-to-host copy
        l1, d_delta, vsum, negl = torch.stack(
            (l1, d_delta, vsum, negl)).cpu().tolist()
        uni = uni_next
        uni_budget += abs(g) * n_valid / norm
        if uni_budget + negl_budget + tol_slack > budget:
            return None  # dangling mass drifted too far for partial
        d_arr += float(d_delta)
        if not expand:
            negl_budget += float(negl) / norm
            if uni_budget + negl_budget + tol_slack > budget:
                return None  # neglected-propagation budget exhausted
        # full-vector per-sweep L1 change: exact on the observed rows,
        # uniform |g| on every other valid coordinate
        l1_full = float(l1) + abs(g) * max(n_valid - float(vsum), 0.0)
        residual = l1_full / norm
        if residual <= eff_tol:
            break
        # stall guard: a residual pinned NEAR the dtype's oscillation
        # floor above eff_tol means the tol is unreachable in this
        # precision — decline to the next rung instead of burning the
        # cap. Scoped to the floor regime (within ~8x of the floor):
        # a slow-mixing graph stalling far above it keeps its full
        # sweep budget, exactly like the host twin.
        if residual < 0.99 * best_residual:
            best_residual = residual
            stalled = 0
        else:
            stalled += 1
            if stalled >= 6 and residual <= 8.0 * floor:
                return None
        if expand:
            # changed aligns with the SLOT order (insertion order
            # after appends), as do ext_w and the big mask below
            changed_np = changed.cpu().numpy()
            big = np.abs(changed_np) > drop_eps
            if ext is None:
                # external_out_weight wants the sorted membership
                # view; map its per-row output back to slot order
                ext_sorted = external_out_weight(eng, ops.sorted)
                ext = ext_sorted[np.searchsorted(ops.sorted,
                                                 ops.slots)]
            negl_budget += float(
                np.sum(np.abs(changed_np[~big]) * ext[~big])) / norm
            if uni_budget + negl_budget + tol_slack > budget:
                return None  # truncated-expansion budget exhausted
            moved = ops.slots[big]
            if len(moved):
                grown = _fanout(eng, moved)
                new = grown[~_member(ops.sorted, grown)]
                if len(new):
                    # device-side append: gather ONLY the new rows'
                    # in-edges — never rebuild the whole frontier —
                    # and maintain ext incrementally from the SAME
                    # gather: fresh out-edge walk for the appended
                    # rows, subtraction for the boundary-crossing
                    # ones (their destinations moved inside the set)
                    old_sorted = ops.sorted
                    old_slots = ops.slots
                    in_edges = ops.append(new)
                    ext = _expand_ext_slots(eng, old_sorted, old_slots,
                                            ext, ops.sorted, new,
                                            in_edges)
                    # new rows legitimately move the residual: the
                    # stall guard restarts on every expansion
                    best_residual = np.inf
                    stalled = 0
    else:
        return None
    s_out = s_dev.cpu().numpy().astype(np.float64)
    if uni != 0.0:
        s_out = s_out + uni * valid
    return PartialResult(s_out, sweep, residual, peak,
                         budget_spent=uni_budget + negl_budget
                         + tol_slack, resamples=resamples)


def _dtype_floor(eng) -> float:
    """The device sweeps' residual floor: 8 ulps of the engine's dtype
    (the reference reads JAX's default float, f64 under x64)."""
    return 8.0 * float(torch.finfo(eng.dtype).eps)


def device_partial_refresh(eng, s0, frontier, tol: float,
                           max_sweeps: int, frontier_limit: int,
                           error_budget: float = 0.0
                           ) -> PartialResult | None:
    """``partial.partial_refresh``'s device twin: same footing, bounds
    and residual semantics, with the per-sweep reduction on device and
    the score vector device-resident across sweeps. None = out of
    budget / frontier outgrew the limit — try the next ladder rung."""
    F = as_frontier_array(frontier)
    F = F[(F >= 0) & (F < eng.n_now)]
    with trace.span("partial.device", n=eng.n_now, frontier=len(F)):
        return _device_sweeps(eng, s0, F, tol, max_sweeps,
                              frontier_limit, None,
                              error_budget=error_budget)


def refresh_seed(F: np.ndarray, s0) -> list:
    """The per-refresh seed material of the sampled mode's Gumbel
    draws: the frontier shape and its warm score mass — deterministic
    for a given refresh, varying across refreshes. The per-SWEEP rngs
    extend it with the sweep index (see :func:`sampled_refresh`)."""
    s0 = np.asarray(s0, dtype=np.float64)
    mass = np.abs(s0[F]).sum()
    return [len(F), int(F[0]), int(F[-1]),
            int(np.float64(mass).view(np.uint64))]


def sample_set(eng, F: np.ndarray, s0, budget: int,
               rng=None) -> np.ndarray | None:
    """One observation-set draw for the sampled mode: the frontier
    plus its fan-out closure, importance-sampled down to ``budget``
    rows when a hop overflows it (Gumbel top-k on warm-start score
    mass — heavy rows absorb most of the L1 the un-observed complement
    would accumulate). None when the frontier alone exceeds the
    budget."""
    S, _ = _sample_set_trimmed(eng, F, s0, budget, rng)
    return S


def _sample_set_trimmed(eng, F: np.ndarray, s0, budget: int,
                        rng=None) -> tuple:
    """(set, trimmed): ``trimmed`` says whether the Gumbel actually
    cut a hop down to the budget. For fixed (F, s0, budget) the walk
    is deterministic UNTIL the first trim, so an untrimmed draw cannot
    differ between sweeps — :func:`sampled_refresh` uses that to skip
    the per-sweep closure walk entirely in the no-trim regime."""
    if len(F) > budget:
        return None, False
    if not len(F):
        return F, False
    s0 = np.asarray(s0, dtype=np.float64)
    if rng is None:
        rng = np.random.default_rng(refresh_seed(F, s0))
    S = F
    hop = F
    trimmed = False
    while len(S) < budget and len(hop):
        nxt = _fanout(eng, hop)
        nxt = nxt[(nxt >= 0) & (nxt < eng.n_now)]
        nxt = nxt[~_member(S, nxt)]
        if not len(nxt):
            break
        room = budget - len(S)
        if len(nxt) > room:
            trimmed = True
            mass = np.abs(s0[nxt]) + 1e-300
            keys = np.log(mass) + rng.gumbel(size=len(nxt))
            nxt = nxt[np.argpartition(-keys, room - 1)[:room]]
        S = np.union1d(S, nxt)
        hop = nxt
    return S, trimmed


def sampled_refresh(eng, s0, frontier, tol: float, max_sweeps: int,
                    sample_budget: int, error_budget: float = 0.0,
                    rng=None) -> PartialResult | None:
    """Partially-observed refresh with PER-SWEEP resampling (arXiv
    2606.11956): every sweep converges on a freshly-drawn observation
    set S_t = frontier ∪ Gumbel-top-k(fan-out closure) ≤
    ``sample_budget``, with the neglected-propagation mass accumulated
    against the honesty budget (``max(tol, error_budget)`` — see
    module docstring). Each draw is seeded per (refresh, sweep) —
    ``refresh_seed(F, s0) + [sweep]`` — so runs stay deterministic
    while long sampled streaks between cold resyncs stop neglecting
    the SAME complement rows sweep after sweep (the known bias of the
    old per-refresh draw). When the closure fits the budget whole, the
    Gumbel never trims and every draw is the same set — the operands
    build once and ``resamples`` stays 0. An explicit ``rng`` replaces
    the seeded per-sweep generators with one sequential stream (test
    seam). None = no footing, frontier past the budget, or budget
    exhausted — fall back to the full device sweep."""
    F = as_frontier_array(frontier)
    F = F[(F >= 0) & (F < eng.n_now)]
    if not len(F):
        return PartialResult(np.asarray(s0, dtype=np.float64).copy(),
                             0, 0.0, 0)
    with trace.span("partial.sampled", n=eng.n_now, frontier=len(F)):
        base_seed = refresh_seed(F, s0)

        def draw(sweep: int):
            r = rng if rng is not None else np.random.default_rng(
                base_seed + [sweep])
            return sample_set(eng, F, s0, sample_budget, rng=r)

        S, trimmed = _sample_set_trimmed(
            eng, F, s0, sample_budget,
            rng=(rng if rng is not None
                 else np.random.default_rng(base_seed + [1])))
        if S is None:
            return None
        ext_w = external_out_weight(eng, S)
        # no-trim regime: the closure walk is deterministic for fixed
        # (F, s0, budget) until the first trim, so every redraw would
        # return the SAME set — skip the per-sweep O(closure) walk
        # entirely instead of re-walking just to array-compare it
        return _device_sweeps(eng, s0, S, tol, max_sweeps, None, ext_w,
                              error_budget=error_budget,
                              resample=draw if trimmed else None)


def ladder_refresh(eng, s0, frontier, tol: float, max_sweeps: int,
                   frontier_limit: int, device_threshold: int = 4096,
                   sample_budget: int = 0, error_budget: float = 0.0,
                   rng=None):
    """The sublinear refresh ladder, made explicit:

    1. ``partial`` — host sweeps (frontier under both the limit and
       ``device_threshold``: interpreter dispatch beats device round
       trips at tiny frontiers);
    2. ``device_partial`` — the device kernel (frontier ≥
       ``device_threshold``; 0 = always device, < 0 = never);
    3. ``sampled`` — partially-observed sweeps over ≤ ``sample_budget``
       rows (0 disables) when the frontier outgrew the partial bound
       or a partial attempt declined mid-flight.

    ``error_budget`` (relative L1) is the declared sublinearity price
    every rung charges its neglected-propagation mass against — 0
    means exact mode (budget = tol), under which small-world frontiers
    flood and honestly decline to the full sweep.

    Returns ``(PartialResult, mode)`` or ``(None, None)`` — the
    caller's remaining rungs are the full device sweep on the patched
    operator, then the rebuild path.
    """
    F = as_frontier_array(frontier)
    F = F[(F >= 0) & (F < eng.n_now)]
    if len(F) <= frontier_limit:
        if 0 <= device_threshold <= len(F):
            res = device_partial_refresh(eng, s0, F, tol, max_sweeps,
                                         frontier_limit,
                                         error_budget=error_budget)
            if res is not None:
                return res, "device_partial"
            # a device decline under a budget too small to absorb the
            # kernel dtype's tol slack may be precision-caused, not a
            # genuine flood — the f64 host twin can still serve
            # exact-mode local churn (the documented ladder). In the
            # absorbing config the decline was honest; skip the rung.
            floor = _dtype_floor(eng)
            if tol < floor and floor > max(tol, error_budget) + tol:
                res = partial_refresh(eng, s0, F, tol, max_sweeps,
                                      frontier_limit,
                                      error_budget=error_budget)
                if res is not None:
                    return res, "partial"
        else:
            res = partial_refresh(eng, s0, F, tol, max_sweeps,
                                  frontier_limit,
                                  error_budget=error_budget)
            if res is not None:
                return res, "partial"
    if sample_budget > 0 and len(F):
        res = sampled_refresh(eng, s0, F, tol, max_sweeps,
                              sample_budget, error_budget=error_budget,
                              rng=rng)
        if res is not None:
            return res, "sampled"
    return None, None
