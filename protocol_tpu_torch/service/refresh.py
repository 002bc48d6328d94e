"""Incremental score refresh: warm-started power iteration.

The insight this loop productizes (PAPERS.md — "Analysis of Power
Iteration with Partially Observed Matrix-vector Products", arXiv
2606.11956): when only a small slice of the opinion matrix changed, the
previous fixed point is within O(‖ΔC‖) of the new one, so restarting
the adaptive converge from it reaches tolerance in a handful of
iterations instead of the full cold O(log(1/tol)/spectral-gap) sweep.
The refresher therefore:

1. snapshots the opinion graph (one lock hold),
2. builds the warm-start vector from the last published scores
   (``ops.converge.warm_start_scores`` — append-only ids make the
   projection a pad + mass rescale),
3. runs the ConvergeBackend adaptive converge (the same seam the batch
   verbs use — device faults injectable via ``faults.py``),
4. publishes an immutable :class:`ScoreTable` the HTTP layer serves
   lock-free (attribute swap).

Past a staleness bound — too many edits since the last cold converge,
or every ``cold_every`` refreshes as a drift backstop — the warm start
is skipped and the iteration runs cold from uniform, re-anchoring the
vector. Warm and cold converge to the same fixed point on ergodic
graphs; the periodic cold resync bounds the error for adversarially
disconnected ones.

Two scale/restart seams on top:

- **restored tables** (:meth:`ScoreRefresher.install`): the daemon's
  snapshot restore hands the last persisted table straight back, so the
  first post-restart refresh warm-starts from the old fixed point
  instead of a forced cold resync;
- **routed refresh** (``routed_edge_threshold``): past the threshold
  the snapshot-and-rebuild-the-ELL-operator-per-refresh pattern stops
  scaling, so the refresh routes through ``TorchRoutedBackend`` (the
  route-stage kernel on the card) with a
  digest-keyed compiled-operator cache (in-memory slot + on-disk under
  the state dir), warm vectors entering through the operator's
  ``scores_from_nodes`` path. Cache hits — the warm→cold fallback, the
  periodic cold resync, and every post-restart refresh of an unchanged
  graph — skip the rebuild entirely (``operator_hits`` proves it).

And the write-path scale seam:

- **delta maintenance** (``delta_updates``, on by default): once the
  routed path has compiled an operator, the refresher anchors a
  ``incremental.DeltaEngine`` on it and every subsequent
  churn window is absorbed in O(dirty): the graph's edge-change log
  (drained via ``graph.delta_cut()`` — one lock hold, NO O(E)
  edge-array materialization) is classified into weight
  revisions (value-buffer patches), structural inserts/removes (the
  COO overflow tail) and dirty-row re-normalizations — the routing
  plan is never rebuilt until the tail outgrows its budget, which
  demotes full builds (``ptpu_operator_full_builds_total``) to a rare
  amortized event. Warm refreshes walk the explicit **sublinear
  ladder** (``incremental.ladder_refresh``): host partial sweeps over
  the dirty frontier + fan-in for tiny frontiers, the device
  segment gather (``ops.converge.partial_sweep_device``) past
  ``device_partial_threshold``, the
  partially-observed **sampled** mode (frontier + importance-sampled
  closure ≤ ``sample_budget``, neglected-propagation mass charged to
  the L1 honesty budget) once the frontier outgrows the partial
  bound — and only a genuinely exhausted budget falls back to a full
  (still rebuild-free) device sweep; every refresh reports which
  scope it swept via ``ptpu_refresh_sweep_scope_total{mode=partial|
  device_partial|sampled|full|rebuild}`` (``rebuild`` = served by the
  build path: the initial anchor and every re-anchor after a capacity
  wall or lost log), with the frontier width and budget spend live on
  ``ptpu_refresh_frontier_peak`` / ``ptpu_refresh_budget_spent``.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass

import numpy as np

from ..utils import trace
from .config import ServiceConfig
from .faults import FaultInjector
from .state import OpinionGraph


@dataclass(frozen=True)
class ScoreTable:
    """One published refresh result (immutable; swapped atomically)."""

    addresses: tuple      # id -> 20-byte address
    scores: np.ndarray    # float scores, id order
    revision: int         # graph revision this table reflects
    iterations: int
    delta: float
    cold: bool
    computed_at: float

    def __post_init__(self):
        # O(1) address lookups for /score/<addr>: built once per
        # publish, not a linear scan per HTTP request (frozen dataclass
        # → assign through object.__setattr__)
        object.__setattr__(
            self, "_index",
            {a: i for i, a in enumerate(self.addresses)})

    def score_of(self, addr: bytes):
        i = self._index.get(addr)
        return None if i is None else float(self.scores[i])

    @property
    def digest(self) -> bytes:
        """sha256 over the served content (address list + float64
        score bytes) — computed once per published table, shared by
        the ``/scores`` ETag and the signed score bundle, so a cache
        hit and a bundle signature commit to the same bytes."""
        d = getattr(self, "_digest", None)
        if d is None:
            h = hashlib.sha256()
            h.update(len(self.addresses).to_bytes(8, "little"))
            for a in self.addresses:
                h.update(a)
            h.update(np.ascontiguousarray(
                np.asarray(self.scores, dtype=np.float64)).tobytes())
            d = h.digest()
            object.__setattr__(self, "_digest", d)
        return d

    @property
    def etag(self) -> str:
        """Strong ETag of the published table: graph-revision-prefixed
        (the cheap invalidation signal) + content digest (exactness —
        a restored table after restart keeps its ETag, a republish at
        a new revision changes it)."""
        return f'"sc-{self.revision}-{self.digest[:12].hex()}"'


_EMPTY = ScoreTable(addresses=(), scores=np.zeros(0), revision=-1,
                    iterations=0, delta=0.0, cold=True, computed_at=0.0)


class ScoreRefresher:
    """Owns the backend + the published table; one refresh at a time."""

    def __init__(self, graph: OpinionGraph, config: ServiceConfig,
                 backend=None, faults: FaultInjector | None = None,
                 operator_cache_dir: str | None = None,
                 pending_traces=None, recorder=None, device=None):
        """``pending_traces``: optional ``trace.PendingTraces`` — the
        ingest sink records applied attestations' trace ids there; each
        refresh takes the ids at-or-below the revision it publishes and
        stamps them on its span, closing the tailer → WAL → apply →
        refresh trace chain. ``device``: the torch device of the
        default backend, the routed backend and the delta engine (None
        means the card, and raises without one); an injected backend
        with a device of its own sets it instead."""
        self.graph = graph
        self.config = config
        self.pending_traces = pending_traces
        # optional FlightRecorder: plan builds note their device-cost
        # row into the incident ring
        self.recorder = recorder
        self.faults = faults or FaultInjector({"rpc": 0.0, "device": 0.0})
        if backend is None:
            from ..backend import TorchSparseBackend

            backend = TorchSparseBackend(device=device)
        self.backend = backend
        self.device = getattr(backend, "device", None)
        if self.device is None:
            from ..device import resolve_device

            self.device = resolve_device(device)
        self.table: ScoreTable = _EMPTY
        self.refreshes = 0
        self.cold_refreshes = 0
        self.warm_iterations = 0  # cumulative, warm refreshes only
        # routed-operator cache (the at-scale path): one in-memory slot
        # keyed by edge-list digest + optional on-disk spill
        self.operator_cache_dir = operator_cache_dir
        self._routed_backend = None
        self._op = None
        self._op_digest = None
        self.operator_hits = 0
        self.operator_builds = 0
        # incremental delta engine (anchored after a routed build)
        self.delta_engine = None
        self.delta_batches = 0      # churn windows absorbed in-place
        self.partial_refreshes = 0  # refreshes served below "full":
        # any ladder rung (host partial, device partial, sampled)
        self.device_partial_refreshes = 0
        self.sampled_refreshes = 0
        self.full_sweeps = 0        # delta-path full device sweeps
        self.delta_reanchors = 0    # engines discarded (capacity/log)
        self.last_frontier_peak = 0   # widest frontier, last sublinear
        self.last_budget_spent = 0.0  # its accumulated L1 budget spend

    def install(self, table: ScoreTable) -> None:
        """Adopt a restored table (snapshot restore): the next refresh
        warm-starts from it instead of running a forced cold resync."""
        self.table = table

    def stale(self) -> bool:
        return self.graph.revision != self.table.revision

    def _want_cold(self, n_edges: int, edits: int) -> bool:
        if self.table.revision < 0:
            return True  # nothing to warm-start from
        # self.refreshes == 0 with a live table means a RESTORED table
        # (snapshot restore): warm-start from it, don't force the
        # periodic resync on the very first post-restart refresh
        if self.config.cold_every and self.refreshes and (
                self.refreshes % self.config.cold_every == 0):
            return True
        return edits > self.config.cold_edit_fraction * max(n_edges, 1)

    # --- routed-operator cache (refresh at scale) -------------------------
    def _routed_operator(self, n, src, dst, val, valid):
        """The compiled RoutedOperator for this exact edge list: from
        the in-memory slot, else the on-disk cache, else a fresh build
        (saved back when a cache dir is configured). Digest-keyed on the
        edge content, so a changed graph can never load a stale plan."""
        h = hashlib.sha256()
        h.update(f"routed:v1:n={n}".encode())
        for a in (src, dst, val, valid):
            # valid included: a mask-only change (future peer bans)
            # must never reuse an operator compiled under another mask
            h.update(np.ascontiguousarray(a).tobytes())
        digest = h.hexdigest()
        if self._op is not None and self._op_digest == digest:
            self.operator_hits += 1
            return self._op
        from ..ops.routed import RoutedOperator, build_routed_operator

        path = None
        if self.operator_cache_dir:
            os.makedirs(self.operator_cache_dir, exist_ok=True)
            path = os.path.join(self.operator_cache_dir,
                                f"routed_{digest[:24]}.npz")
            if os.path.exists(path):
                try:
                    with trace.span("service.operator_load", path=path):
                        op = RoutedOperator.load(path)
                    self._op, self._op_digest = op, digest
                    self.operator_hits += 1
                    self._capture_plan_cost(op)
                    return op
                except Exception:  # noqa: BLE001 - corrupt cache entry:
                    # rebuild rather than brick the refresh loop
                    trace.event("service.operator_cache_unreadable",
                                path=path)
        with trace.span("service.operator_build", n=n, edges=len(src)):
            op = build_routed_operator(n, src, dst, val, valid)
        self.operator_builds += 1
        if path is not None:
            try:
                op.save(path)
                self._prune_operator_cache(keep=4)
            except OSError:
                trace.event("service.operator_cache_write_failed",
                            path=path)
        self._op, self._op_digest = op, digest
        self._capture_plan_cost(op)
        return op

    def _capture_plan_cost(self, op) -> None:
        """Device-cost attribution at plan adoption (fresh build OR
        disk load — either way this is the plan served next): the
        analytic flops and bytes of one routed sweep at the plan's
        shapes into the ``ptpu_plan_*`` gauges (host arithmetic on the
        operator; nothing moves to the device). Best-effort: cost
        capture must never fail a refresh."""
        try:
            from .recorder import capture_routed_plan_cost

            capture_routed_plan_cost(
                op, dtype=getattr(self.backend, "dtype", None),
                recorder=self.recorder)
        except Exception:  # noqa: BLE001 - attribution is advisory
            pass

    def _prune_operator_cache(self, keep: int) -> None:
        """Drop all but the newest ``keep`` cached operators: under
        continuous ingest every refresh has a new digest, and the
        cache's value is restart / unchanged-graph hits — only the
        recent entries matter, the tail is just disk growth."""
        entries = []
        for name in os.listdir(self.operator_cache_dir):
            if name.startswith("routed_") and name.endswith(".npz"):
                p = os.path.join(self.operator_cache_dir, name)
                try:
                    entries.append((os.path.getmtime(p), p))
                except OSError:
                    continue
        for _, p in sorted(entries)[:-keep]:
            try:
                os.remove(p)
            except OSError:
                pass

    def _converge_call(self, n, src, dst, val, valid):
        """(backend, extra-kwargs) for this refresh: the routed path
        with a cached operator past the edge threshold, the configured
        backend otherwise."""
        threshold = self.config.routed_edge_threshold
        if not threshold or len(src) < threshold:
            return self.backend, {}
        from ..backend import TorchRoutedBackend

        if isinstance(self.backend, TorchRoutedBackend):
            be = self.backend
        else:
            if self._routed_backend is None:
                self._routed_backend = TorchRoutedBackend(
                    dtype=getattr(self.backend, "dtype", None),
                    device=self.device)
            be = self._routed_backend
        op = self._routed_operator(n, src, dst, val, valid)
        return be, {"operator": op}

    def refresh(self, force_cold: bool = False) -> ScoreTable:
        """Converge the current graph and publish; returns the table
        (unchanged table if the graph is empty/unchanged). Raises
        EigenError on (injected) device faults — the caller loop owns
        retry; the previously published table stays live throughout."""
        # fast path: an anchored engine serves the churn window from
        # graph.delta_cut() — O(dirty) — never touching the O(E)
        # edge-array walk of graph.snapshot(), which at 10M-peer scale
        # is seconds of Python dict iteration under the lock the
        # ingest sink needs. The full cut is deferred to the (rare)
        # build path below, where it feeds the rebuild it's amortized
        # into.
        if self.delta_engine is not None and self.config.delta_updates:
            n, revision, edits, deltas, deltas_lost = \
                self.graph.delta_cut()
            if revision == self.table.revision:
                if deltas or deltas_lost:
                    # defensive: an effective change always bumps the
                    # revision, but never drop a drained delta (and a
                    # lost log must discard the engine even here)
                    self._absorb_deltas(n, deltas, deltas_lost)
                return self.table
            if self._absorb_deltas(n, deltas, deltas_lost):
                if n >= 2:
                    return self._refresh_via_delta(n, revision, edits,
                                                   force_cold)
                # a <2-peer graph can't have anchored a routed build —
                # defensive only: drop the engine, rebuild below
                self.delta_engine = None
            # engine discarded (capacity wall / lost log): fall
            # through to the build path on a fresh full cut
        n, src, dst, val, revision, edits, deltas, deltas_lost = \
            self.graph.snapshot(drain_deltas=True)
        if revision == self.table.revision:
            if deltas or deltas_lost:
                self._absorb_deltas(n, deltas, deltas_lost)
            return self.table
        addresses = self.graph.addresses()[:n]
        if n < 2 or not len(src):
            # no scorable graph yet: publish the empty/zero table so
            # /scores reflects "seen but unscored" peers honestly. The
            # pending trace ids ARE reflected by this publish — drain
            # them here (stamped on an event, there is no converge
            # span) or they would be misattributed to a later refresh
            tids = (self.pending_traces.take(revision)
                    if self.pending_traces is not None else [])
            self.table = ScoreTable(addresses, np.zeros(n), revision,
                                    0, 0.0, True, time.time())
            if tids:
                with trace.context(trace_ids=tids):
                    trace.event("service.refresh_trivial", n=n,
                                revision=revision)
            return self.table

        cold = force_cold or self._want_cold(len(src), edits)
        valid = np.ones(n, dtype=bool)
        # a drained delta log on this path is baseline-reset: either no
        # engine exists, or it was just discarded — the rebuild below
        # (and the re-anchor after it) IS the new baseline
        s0 = self._warm_vector(n, valid) if not cold else None
        self.faults.check("device")
        backend, extra = self._converge_call(n, src, dst, val, valid)
        # the refresh span carries the trace ids of every attestation
        # it is about to make visible in served scores (the last hop of
        # the tailer → WAL → apply → refresh chain)
        tids = (self.pending_traces.take(revision)
                if self.pending_traces is not None else [])
        t0 = time.perf_counter()
        try:
            scores, iters, delta, cold = self._converge_traced(
                n, src, dst, val, valid, s0, cold, tids, backend,
                extra)
        except Exception:
            # a failed refresh publishes nothing: the ids go back so
            # the retry's span still closes the trace chain
            if self.pending_traces is not None and tids:
                self.pending_traces.add(revision, tids)
            raise
        trace.histogram("refresh_seconds").observe(
            time.perf_counter() - t0, mode="cold" if cold else "warm")
        self._anchor_delta_engine(n, src, dst, val, valid,
                                  extra.get("operator"))
        # every refresh reports its sweep scope — build-served ones as
        # "rebuild", so a thrashing delta engine (constant re-anchors)
        # shows up in the partial/full/rebuild ratio instead of
        # silently vanishing from it
        from ..ops.converge import record_refresh_scope

        record_refresh_scope("rebuild")
        return self._publish(addresses, scores, n, revision, iters,
                             delta, cold, edits)

    def _warm_vector(self, n, valid):
        from ..ops.converge import warm_start_scores

        # node-order warm vector; the routed backend translates it
        # to state-slot order via the operator's scores_from_nodes
        return warm_start_scores(self.table.scores, n, valid,
                                 self.config.initial_score)

    def _refresh_via_delta(self, n: int, revision: int, edits: int,
                           force_cold: bool) -> ScoreTable:
        """One refresh served entirely by the anchored engine (the
        churn window is already absorbed): partial or full sweep on
        the patched operator, publish — no edge arrays, no builds."""
        addresses = self.graph.addresses()[:n]
        cold = force_cold or self._want_cold(self.delta_engine.nnz_now,
                                             edits)
        s0 = (self._warm_vector(n, np.ones(n, dtype=bool))
              if not cold else None)
        self.faults.check("device")
        tids = (self.pending_traces.take(revision)
                if self.pending_traces is not None else [])
        t0 = time.perf_counter()
        try:
            scores, iters, delta, cold = self._converge_delta(
                n, s0, cold, tids)
        except Exception:
            if self.pending_traces is not None and tids:
                self.pending_traces.add(revision, tids)
            raise
        trace.histogram("refresh_seconds").observe(
            time.perf_counter() - t0, mode="cold" if cold else "warm")
        return self._publish(addresses, scores, n, revision, iters,
                             delta, cold, edits)

    def _publish(self, addresses, scores, n, revision, iters, delta,
                 cold, edits) -> ScoreTable:
        self.refreshes += 1
        if cold:
            self.cold_refreshes += 1
            # only the ``edits`` this refresh's cut saw: those applied
            # while it converged still count toward the next one
            self.graph.mark_cold(edits)
        else:
            self.warm_iterations += int(iters)
        self.table = ScoreTable(addresses, np.asarray(scores)[:n],
                                revision, int(iters), float(delta), cold,
                                time.time())
        trace.metric("service.refresh_total", self.refreshes)
        trace.metric("service.refresh_cold_total", self.cold_refreshes)
        trace.metric("service.refresh_iterations", int(iters))
        trace.metric("service.refresh_delta", float(delta))
        trace.metric("service.operator_cache_hits", self.operator_hits)
        trace.metric("service.operator_builds", self.operator_builds)
        trace.metric("service.delta_batches", self.delta_batches)
        trace.metric("service.partial_refreshes", self.partial_refreshes)
        trace.metric("service.device_partial_refreshes",
                     self.device_partial_refreshes)
        trace.metric("service.sampled_refreshes", self.sampled_refreshes)
        return self.table

    def _converge_traced(self, n, src, dst, val, valid, s0, cold,
                         tids, backend, extra) -> tuple:
        """The converge (+ warm→cold fallback) under the batch's trace
        context; returns ``(scores, iters, delta, cold)``."""
        with trace.context(trace_ids=tids):
            with trace.span("service.refresh", n=n, edges=len(src),
                            cold=cold,
                            backend=type(backend).__name__):
                scores, iters, delta = backend.converge_edges(
                    n, src, dst, val, valid, self.config.initial_score,
                    self.config.max_iterations, tol=self.config.tol,
                    alpha=self.config.alpha, s0=s0, **extra)
            if not cold and (delta > self.config.tol
                             or not np.isfinite(scores).all()):
                # warm start failed to converge inside the budget (graph
                # drifted further than the bound assumed): re-anchor
                # cold. The routed fallback reuses the operator just
                # built/loaded — a cache hit, not a second compilation.
                backend, extra = self._converge_call(n, src, dst, val,
                                                     valid)
                with trace.span("service.refresh", n=n, edges=len(src),
                                cold=True, fallback=True):
                    scores, iters, delta = backend.converge_edges(
                        n, src, dst, val, valid,
                        self.config.initial_score,
                        self.config.max_iterations, tol=self.config.tol,
                        alpha=self.config.alpha, **extra)
                cold = True
        return scores, iters, delta, cold

    # --- incremental delta path (``incremental``) --------------------------
    def _absorb_deltas(self, n: int, deltas, deltas_lost: bool) -> bool:
        """Fold the drained edge-change log into the anchored delta
        engine; True when this refresh can be served from the patched
        operator (no rebuild). A capacity wall / lost log discards the
        engine — the refresh falls through to the build path and
        re-anchors there."""
        eng = self.delta_engine
        if eng is None or not self.config.delta_updates:
            return False
        if deltas_lost:
            trace.event("service.delta_log_lost")
            self.delta_reanchors += 1
            self.delta_engine = None
            return False
        try:
            with trace.span("service.delta_apply", n=len(deltas)):
                ok = eng.apply_deltas(deltas, n=n)
        except Exception:  # noqa: BLE001 - a raise mid-apply (device
            # error in a patch scatter) leaves host truth half-mutated
            # AND the drained batch is gone — the engine is unusable.
            # Discard it and serve this refresh from a full rebuild,
            # which re-anchors a clean baseline.
            trace.event("service.delta_apply_failed")
            self.delta_reanchors += 1
            self.delta_engine = None
            return False
        reason = eng.should_rebuild() if ok else (
            eng.stats.rebuild_reason or "apply_failed")
        if not ok or reason is not None:
            trace.event("service.delta_reanchor", reason=reason)
            self.delta_reanchors += 1
            self.delta_engine = None
            return False
        self.delta_batches += 1
        return True

    def _converge_delta(self, n: int, s0, cold: bool, tids) -> tuple:
        """Serve one refresh from the patched operator, walking the
        explicit sublinear ladder ``partial → device_partial → sampled
        → full`` (``incremental.ladder_refresh``; the rebuild rung
        lives on the build path) — zero routing-plan builds on every
        rung here. Returns ``(scores, iters, delta, cold)``."""
        from ..incremental import ladder_refresh
        from ..ops.converge import (
            record_converge_stats,
            record_refresh_scope,
        )

        eng = self.delta_engine
        frontier, partial_ok = eng.take_frontier()
        try:
            with trace.context(trace_ids=tids):
                with trace.span("service.refresh", n=n,
                                edges=eng.nnz_now, cold=cold,
                                backend="DeltaEngine"):
                    frac = self.config.partial_frontier_fraction
                    if not cold and s0 is not None and partial_ok \
                            and frac > 0:
                        limit = max(1, int(frac * n))
                        t0 = time.perf_counter()
                        res, mode = ladder_refresh(
                            eng, s0, frontier, self.config.tol,
                            self.config.max_iterations, limit,
                            self.config.device_partial_threshold,
                            self.config.sample_budget,
                            self.config.refresh_error_budget)
                        if res is not None:
                            record_converge_stats(
                                mode, res.sweeps, res.residual,
                                time.perf_counter() - t0, n=n)
                            record_refresh_scope(mode)
                            self.partial_refreshes += 1
                            if mode == "device_partial":
                                self.device_partial_refreshes += 1
                            elif mode == "sampled":
                                self.sampled_refreshes += 1
                            self._record_sublinear(mode, res)
                            return (res.scores, res.sweeps,
                                    res.residual, False)
                    # scope/full_sweeps count REFRESHES (per the metric
                    # contract), not converge calls — the warm→cold
                    # fallback below is still this one refresh
                    record_refresh_scope("full")
                    self.full_sweeps += 1
                    start = (s0 if not cold and s0 is not None else
                             eng.initial_node_scores(
                                 self.config.initial_score))
                    scores, iters, delta = eng.converge(
                        start, self.config.max_iterations,
                        self.config.tol)
                    if not cold and (delta > self.config.tol
                                     or not np.isfinite(scores).all()):
                        # warm start failed to converge in budget:
                        # re-anchor the VECTOR cold — the patched
                        # operator is reused as-is, no build
                        with trace.span("service.refresh", n=n,
                                        cold=True, fallback=True):
                            scores, iters, delta = eng.converge(
                                eng.initial_node_scores(
                                    self.config.initial_score),
                                self.config.max_iterations,
                                self.config.tol)
                        cold = True
                    return scores, iters, delta, cold
        except Exception:
            # the retry must still see the dirty frontier
            eng.restore_frontier(frontier, partial_ok)
            raise

    def _record_sublinear(self, mode: str, res) -> None:
        """Sublinear-refresh observability: the frontier width and the
        accumulated L1 honesty-budget spend were trapped inside
        ``PartialResult`` — surface them as live gauges plus a
        per-mode frontier-size histogram so dashboards can watch the
        freshness-vs-compute frontier drift."""
        self.last_frontier_peak = int(res.frontier_peak)
        self.last_budget_spent = float(res.budget_spent)
        trace.gauge("refresh_frontier_peak").set(
            float(res.frontier_peak))
        trace.gauge("refresh_budget_spent").set(
            float(res.budget_spent))
        trace.histogram(
            "refresh_frontier_rows",
            buckets=trace.FRONTIER_ROWS_BUCKETS).observe(
            float(res.frontier_peak), mode=mode)

    def _anchor_delta_engine(self, n, src, dst, val, valid,
                             operator) -> None:
        """After a refresh that ran through a ROUTED operator build (or
        cache load), anchor the delta engine on it so the next churn
        window is absorbed in place. O(E) numpy, amortized into the
        build it makes rare; anchoring failure degrades to the rebuild
        path, never fails the refresh."""
        if operator is None or not self.config.delta_updates:
            return
        from ..incremental import DeltaEngine

        try:
            with trace.span("service.delta_anchor", n=n,
                            edges=len(src)):
                self.delta_engine = DeltaEngine.anchor(
                    n, src, dst, val, valid, operator,
                    dtype=getattr(self.backend, "dtype", None),
                    alpha=self.config.alpha,
                    tail_max=self.config.delta_tail_max,
                    tail_fraction=self.config.delta_tail_fraction,
                    device=self.device)
        except Exception:  # noqa: BLE001 - a failed anchor must not
            # take down the refresh loop; the next refresh rebuilds
            trace.event("service.delta_anchor_failed")
            self.delta_engine = None

    def delta_status(self) -> dict:
        """Delta-engine view for ``GET /status``."""
        eng = self.delta_engine
        out = {
            "anchored": eng is not None,
            "batches_absorbed": self.delta_batches,
            "partial_refreshes": self.partial_refreshes,
            "device_partial_refreshes": self.device_partial_refreshes,
            "sampled_refreshes": self.sampled_refreshes,
            "full_sweeps": self.full_sweeps,
            "reanchors": self.delta_reanchors,
            "frontier_peak": self.last_frontier_peak,
            "budget_spent": self.last_budget_spent,
            # the DECLARED sublinearity price: the service smoke's scenario
            # phase holds served scores to this bound under adversarial
            # churn, so it must be visible over the wire, not just in
            # the operator's config file
            "error_budget": self.config.refresh_error_budget,
        }
        if eng is not None:
            out.update({
                "tail": len(eng.tail_index),
                # the port's tail holds one entry per edge (no pow2
                # padding), so its capacity is its length
                "tail_capacity": len(eng.tail_raw_np),
                "dirty_rows": len(eng.dirty_rows),
                "new_peers": eng.stats.new_peers,
            })
        return out

    def run(self, stop_event, dirty_event, refresh_interval: float,
            beat=None) -> None:
        """Refresher loop: wake on new data (or the interval), refresh,
        repeat. Failures (injected device faults included) back off one
        interval and retry — the published table is never torn down on
        failure. ``beat`` (optional callable): stall-watchdog
        heartbeat, called every wake — a device hang inside refresh()
        reads as a stall, an idle interval does not."""
        while not stop_event.is_set():
            if beat is not None:
                beat()
            dirty_event.wait(refresh_interval)
            if stop_event.is_set():
                return
            dirty_event.clear()
            if not self.stale():
                continue
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - daemon thread: serve the
                # last good table and retry rather than dying
                trace.event("service.refresh_failed")
                stop_event.wait(refresh_interval)
                dirty_event.set()  # data is still pending — retry
