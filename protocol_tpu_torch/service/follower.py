"""Follower replicas: hermetic read daemons over shipped WAL segments.

The port of ``protocol_tpu/service/follower.py``, copied whole with one
seam: the constructor takes ``device`` (None: the card), and the
follower's refresher (the routed operator and the delta engine, B1) and
its signer recovery (``state.recover_signers``: in batch on the card
from 32 lanes up, B2 and its companions) run there, as the leader's do
(``daemon.py``). ``device="cpu"`` keeps both on the CPU, the recovery
scalar.

One leader daemon is both the compute engine and the only read endpoint
— every ``/scores`` hit contends with converge refreshes, delta
absorption and the proof pool. The read path is the uniquely scalable
half (published scores are *provable*; see ``bundle.py``), so this
module splits it out: a :class:`FollowerService` is a ``serve --follow
<leader-url>`` process that

1. **bootstraps** from the leader's newest snapshot
   (``GET /repl/snapshot``) — adopted through the exact
   ``decode_service_state`` restore path and re-committed LOCALLY so
   its own restarts never re-bootstrap;
2. **tails** the leader's shipped WAL (``GET /repl/wal?from=seg:off``)
   with the chain tailer's retry + exponential backoff discipline,
   appending every record to its OWN local WAL (append-before-apply,
   content dedup — the leader sink's exact durability contract) and
   applying edges through the same ``OpinionGraph`` → ``ScoreRefresher``
   ladder the leader runs;
3. **serves** ``/scores``, ``/score/<addr>``, ``/healthz``,
   ``/metrics``, ``/status`` and the leader's signed ``/bundle``
   (cached verbatim — the signature is the leader's, a replica can't
   and needn't re-sign) hermetically: no chain tailer, no proof pool,
   ``POST /proofs`` answers 503 read-only.

Per-replica honesty gauges: ``ptpu_score_freshness_seconds`` measures
now − arrival AT THIS REPLICA of the newest record its published table
reflects (replication lag is inside the number, not hidden), and the
``ptpu_repl_lag_records`` / ``ptpu_repl_lag_seconds`` pair report the
shipping backlog and the time since this replica last saw the leader's
committed tail.

Durability reuses the leader's store formats and write ordering:
local snapshots every ``snapshot_every`` edits
(``daemon.commit_service_snapshot``), replication cursor (the leader
WAL position) persisted through ``CheckpointManager`` AFTER the local
append+apply — a SIGKILL between loses at most one chunk's cursor
advance, and the refetch dedups by content. The local WAL is bounded
the same way the leader's is: once it holds ``wal_compact_segments``
segments, latest-wins duplicates per recovered ``(signer, about)``
fold into a fresh segment (startup after restore + the live snapshot
cadence — the leader's exact cursor-floor discipline, transposed).
The fold floor here is a LOCAL WAL position: the log position on disk
at the last SUCCESSFUL replication-cursor persist, saved in the same
checkpoint. Records past it may be refetched after a crash (the
tail resumes from the persisted cursor) and are kept verbatim —
folding one would delete exactly the digest that dedups its refetch.
Records below it were shipped at-or-below the committed cursor, which
the leader never re-ships in normal operation; the one path that can
re-ship them — a leader compaction ``gap`` re-tail — ships the
leader's FOLDED log, whose per-``(signer, about)`` survivor is the
same latest record this follower's fold kept, so content dedup holds.
A pre-existing cursor checkpoint without a floor restores the
conservative ``(0, 0)`` — nothing folds until the first new-format
persist. A gap response otherwise behaves as before: the follower
re-tails the folded log from the earliest position, deduping
everything it already holds — replay of old+folded folds to the
identical state, the same argument that makes compaction crash-safe
on the leader.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ..client.attestation import DOMAIN_PREFIX, SignedAttestationData
from ..utils import trace
from ..utils.checkpoint import CheckpointManager
from ..utils.errors import EigenError
from .config import ServiceConfig
from .daemon import commit_service_snapshot
from .faults import FaultInjector
from .refresh import ScoreRefresher, ScoreTable
from .replication import WalShipClient, format_position
from .state import FreshnessTracker, OpinionGraph, att_digest, \
    recover_signers, trace_id_of


class FollowerService:
    """Read-replica lifecycle: ship-tail + refresh + HTTP."""

    def __init__(self, leader_url: str, domain: bytes,
                 config: ServiceConfig, state_dir: str,
                 checkpoint_dir: str | None = None, backend=None,
                 faults: FaultInjector | None = None,
                 batched_ingest: bool | None = None, device=None):
        """``device``: the torch device of the refresher and the
        batched signer recovery (None means the card, and raises without
        one; ``"cpu"`` runs both on the CPU)."""
        if not state_dir:
            raise EigenError("config_error",
                             "a follower needs a state dir (its local "
                             "WAL + snapshots ARE its durability)")
        if len(domain) != 20:
            raise EigenError("config_error", "domain must be 20 bytes")
        self.leader_url = leader_url.rstrip("/")
        self.domain = domain
        self.config = config
        self.faults = faults or FaultInjector()
        self.batched_ingest = batched_ingest
        if not trace.TRACER.enabled:
            trace.enable()
        from .metrics import declare_instruments

        declare_instruments()
        trace.install_compile_tracking()
        from ..store import StateStore

        self.store = StateStore(
            str(state_dir), segment_bytes=config.wal_segment_bytes,
            fsync=config.wal_fsync, snapshot_keep=config.snapshot_keep,
            faults=self.faults)
        self.graph = OpinionGraph()
        self.pending_traces = trace.PendingTraces()
        # the incident plane, same shape as the leader's: a
        # follower always has a state dir, so it always gets a store
        from .recorder import FlightRecorder, IncidentStore
        from .watchdog import Heartbeats, StallWatchdog

        self.recorder = FlightRecorder(cap=config.incident_ring_cap)
        self.beats = Heartbeats()
        self.incidents = IncidentStore(
            os.path.join(str(state_dir), "incidents"), self.recorder,
            retention=config.incident_retention,
            min_interval=config.incident_min_interval)
        self.watchdog = StallWatchdog(
            self.beats, recorder=self.recorder, store=self.incidents,
            interval=config.watchdog_interval,
            stall_after=config.watchdog_stall_after)
        self.incident_index = self.incidents.index
        self.incident_bundle = self.incidents.load
        self.incident_capture = self._capture_incident
        self.refresher = ScoreRefresher(
            self.graph, config, backend=backend, faults=self.faults,
            operator_cache_dir=self.store.operators_dir,
            pending_traces=self.pending_traces,
            recorder=self.recorder, device=device)
        # the signer recovery runs where the refresher does
        self.device = self.refresher.device
        self.freshness = FreshnessTracker()
        if config.follower_id:
            follower_id = config.follower_id
        else:
            # process-stable (sha256, not hash()): a restarted follower
            # must keep its leader-side row + floor identity
            import hashlib

            follower_id = "f-" + hashlib.sha256(
                os.path.abspath(str(state_dir)).encode()
            ).hexdigest()[:8]
        self.follower_id = follower_id
        # fleet identity + the follower's own SLO engine (evaluated
        # over ITS gauges — a replica's freshness includes repl lag)
        from .slo import SloEngine
        from .telemetry import set_build_info

        self.instance = config.instance_id or follower_id
        self.role = "follower"
        set_build_info(self.instance, self.role)
        self.slo = SloEngine(fast_window=config.slo_fast_window,
                             slow_window=config.slo_slow_window)
        self._last_slo_tick = 0.0
        self.ship = WalShipClient(self.leader_url, follower_id,
                                  max_bytes=config.repl_max_bytes)
        self._cursor_ckpt = CheckpointManager(
            checkpoint_dir or os.path.join(str(state_dir), "repl-cursor"),
            keep=config.cursor_keep)
        self._seen: set = set()
        self._edits_since_snapshot = 0
        self.records_applied = 0
        self.polls = 0
        self.gaps = 0
        self.retries = 0
        self.consecutive_failures = 0
        self.last_backlog = 0
        self._last_eof_at: float | None = None
        self._bundle: tuple | None = None  # (body bytes, etag)
        self._bundle_checked_at = 0.0
        # read-only surface markers the shared HTTP handler checks
        self.jobs = None
        self.repl_source = None
        # local-WAL fold floor: the log position on disk at the last
        # SUCCESSFUL cursor persist (see _compact_wal); conservative
        # (0, 0) until _restore or the first persist raises it
        self._local_floor: tuple = (0, 0)
        self._cursor = self._restore()
        # after restore (the in-memory _seen covers the whole
        # uncompacted log) and after the floor came back with the
        # cursor checkpoint — the leader's constructor-path discipline
        self._compact_wal()
        self._stop = threading.Event()
        self._dirty = threading.Event()
        if self.refresher.stale():
            self._dirty.set()
        self._threads: list = []
        self._server = None
        self._server_thread = None
        self.started_at: float | None = None
        self.draining = False
        self.drain_clean: bool | None = None

    # --- restore / bootstrap ----------------------------------------------
    def _decode_record(self, about: bytes, payload: bytes):
        key = DOMAIN_PREFIX + self.domain
        try:
            return SignedAttestationData.from_log(about, key, payload)
        except EigenError:
            return None

    def _restore(self) -> tuple | None:
        """Local restore (constructor, no threads): newest local
        snapshot + local WAL replay rebuilds graph, table and the
        ``_seen`` dedup set; the persisted replication cursor resumes
        the leader tail. Returns the cursor (None = never synced —
        the first poll bootstraps from the leader)."""
        from ..store import decode_service_state

        t0 = time.monotonic()
        loaded = self.store.snapshots.load_latest()
        wal_start = None
        if loaded is not None:
            _, arrays, meta = loaded
            st = decode_service_state(arrays, meta)
            self._install_state(st)
            wal_start = st["wal_pos"]
        batch, batch_blocks = [], []
        for pos, (blk, about, payload) in \
                self.store.wal.replay_frames():
            digest = att_digest(blk, about, payload)
            if digest in self._seen:
                continue
            signed = self._decode_record(about, payload)
            if signed is None:
                continue
            self._seen.add(digest)
            self.records_applied += 1
            if wal_start is None or pos > wal_start:
                batch.append(signed)
                batch_blocks.append(blk)
        if batch:
            signers = recover_signers(batch,
                                      batched=self.batched_ingest,
                                      device=self.device)
            self.graph.apply(batch, signers)
        cursor = None
        step = self._cursor_ckpt.latest()
        if step is not None:
            _, arrays, _ = self._cursor_ckpt.restore(step)
            cursor = (int(arrays["cursor"][0]), int(arrays["cursor"][1]))
            if "local_floor" in arrays:
                self._local_floor = (int(arrays["local_floor"][0]),
                                     int(arrays["local_floor"][1]))
            # else: pre-floor checkpoint format — keep (0, 0), nothing
            # folds until the first new-format persist
        elif self._seen:
            # applied records but no persisted cursor (crash before the
            # first persist): re-tail from scratch — dedup folds it
            cursor = (0, 0)
        trace.event("follower.restored", peers=self.graph.n,
                    edges=self.graph.n_edges, replayed=len(batch),
                    cursor=(format_position(cursor) if cursor else ""),
                    seconds=round(time.monotonic() - t0, 3))
        return cursor

    def _install_state(self, st: dict) -> None:
        """Adopt one decoded service cut (graph + published table) —
        the shared install step of local restore AND leader bootstrap,
        so a future snapshot field can't update one path and silently
        diverge the other."""
        self.graph.restore_state(st["addrs"], st["edges"],
                                 st["revision"],
                                 st["edits_since_cold"], st["invalid"])
        score_n = len(st["scores"])
        self.refresher.install(ScoreTable(
            addresses=tuple(st["addrs"][:score_n]),
            scores=st["scores"], revision=st["score_revision"],
            iterations=st["iterations"], delta=st["delta"],
            cold=st["cold"], computed_at=st["computed_at"]))

    def _persist_cursor(self) -> None:
        # the local log position NOW covers every record applied under
        # this cursor (append-before-apply, persist after both) — it
        # becomes the fold floor once this save is durable. The
        # in-memory floor only advances on SUCCESS: a failed persist
        # means a post-crash refetch past the OLD cursor, and those
        # records must keep their digests (see _compact_wal)
        pos = self.store.wal.position()
        self._cursor_ckpt.save(
            self.polls,
            {"cursor": np.asarray(list(self._cursor), dtype=np.int64),
             "local_floor": np.asarray(list(pos), dtype=np.int64)},
            meta={"kind": "repl-cursor",
                  "position": format_position(self._cursor)})
        self._local_floor = (int(pos[0]), int(pos[1]))

    def _compact_wal(self) -> None:
        """Local-WAL compaction — the leader's ``_compact_wal`` with
        the fold floor transposed from a chain-block cursor to a LOCAL
        log position: once the log holds ``wal_compact_segments``
        segments, fold latest-wins duplicates per recovered
        ``(signer, about)`` into a fresh segment, keeping every record
        past ``self._local_floor`` verbatim.

        Why the floor is a local position: the follower's refetch unit
        is the shipped chunk past its persisted replication cursor,
        and the local log position at the moment that cursor was
        durably saved bounds exactly the records a post-crash re-tail
        can re-deliver. Folding above it would delete the digest that
        dedups the refetch — the leader's cursor-floor argument,
        verbatim. Below it, normal shipping never re-delivers; a
        leader-compaction ``gap`` re-tail re-ships the leader's FOLDED
        log, whose latest-wins survivor per ``(signer, about)`` is the
        same record this fold keeps, so content dedup still holds.

        Runs at startup after ``_restore`` (the in-memory ``_seen``
        covers the whole uncompacted log either way) and from the
        snapshot cadence in ``_apply_records`` — the poll thread is
        the only local-WAL writer, so no append can race the fold.
        Never fatal: a failed compaction degrades to a bigger log."""
        lim = self.config.wal_compact_segments
        if lim <= 0 or len(self.store.wal.segments()) < lim:
            return
        floor = self._local_floor
        try:
            records = [(pos, blk, about, payload,
                        self._decode_record(about, payload))
                       for pos, (blk, about, payload)
                       in self.store.wal.replay_frames()]
            decoded = [r[4] for r in records if r[4] is not None]
            signers = recover_signers(decoded,
                                      batched=self.batched_ingest,
                                      device=self.device)
            it = iter(signers)
            key_map = {}
            for pos, blk, about, payload, signed in records:
                if signed is None:
                    continue
                signer = next(it)
                if signer is None:
                    continue  # unrecoverable: replay rejects it anyway
                if pos > floor:  # refetchable: keep verbatim
                    key_map[(blk, about, payload)] = (
                        "nofold", blk, about, payload)
                else:
                    key_map[(blk, about, payload)] = (signer, about)
            with trace.span("follower.wal_compact",
                            records=len(records),
                            floor=format_position(floor)):
                out = self.store.wal.compact(
                    lambda b, a, p: key_map.get((b, a, p)))
            trace.event("follower.wal_compacted",
                        records_in=out["records_in"],
                        records_out=out["records_out"],
                        segments_removed=out["segments_removed"])
        except (EigenError, OSError):
            trace.event("follower.wal_compact_failed")

    def _bootstrap(self) -> None:
        """First contact: adopt the leader's newest snapshot (or start
        an empty tail from position 0 when the leader has none). The
        adopted cut is committed LOCALLY with its WAL coverage
        rewritten to THIS follower's (empty) log — leader positions
        mean nothing to a local replay — and the leader position it
        covered becomes the replication cursor."""
        from ..store import decode_service_state

        got = self.ship.fetch_snapshot()
        if got is None:
            self._cursor = (0, 0)
            self._persist_cursor()
            trace.event("follower.bootstrap_empty")
            return
        step, arrays, meta = got
        st = decode_service_state(arrays, meta)
        self._install_state(st)
        local_meta = dict(meta)
        local_pos = self.store.wal.position()
        local_meta["wal_segment"], local_meta["wal_offset"] = \
            int(local_pos[0]), int(local_pos[1])
        try:
            self.store.snapshots.save(step, arrays, local_meta)
        except (EigenError, OSError):
            self.store.snapshot_failures += 1  # degrades to
            # re-bootstrap on restart, never fatal
        self._cursor = st["wal_pos"]
        self._persist_cursor()
        if self.refresher.stale():
            self._dirty.set()
        trace.event("follower.bootstrapped", peers=self.graph.n,
                    edges=self.graph.n_edges,
                    cursor=format_position(self._cursor))

    # --- the ship tail ----------------------------------------------------
    def _apply_records(self, records: list) -> int:
        """The follower sink: dedup → local WAL append → signer
        recovery → graph apply → mark seen → freshness/traces →
        snapshot cadence. The leader sink's exact ordering, so every
        crash-window argument carries over unchanged."""
        fresh = []
        for blk, about, payload in records:
            digest = att_digest(blk, about, payload)
            if digest in self._seen:
                continue
            signed = self._decode_record(about, payload)
            if signed is None:
                continue
            fresh.append((signed, digest, about, payload, blk))
        if not fresh:
            return 0
        with trace.span("follower.wal_append", n=len(fresh)):
            self.store.wal.append(
                [(blk, about, payload)
                 for _, _, about, payload, blk in fresh])
        batch = [signed for signed, _, _, _, _ in fresh]
        with trace.span("follower.ingest", n=len(batch)):
            signers = recover_signers(batch,
                                      batched=self.batched_ingest,
                                      device=self.device)
        with trace.span("follower.graph_apply", n=len(batch)):
            changed = self.graph.apply(batch, signers)
        for _, digest, _, _, _ in fresh:
            self._seen.add(digest)
        self.records_applied += len(fresh)
        tids = [trace_id_of(digest) for _, digest, _, _, _ in fresh]
        if tids:
            self.pending_traces.add(self.graph.revision, tids)
        self.freshness.record(self.graph.revision, time.time())
        self._dirty.set()
        if changed:
            self._edits_since_snapshot += changed
            if self._edits_since_snapshot >= self.config.snapshot_every:
                # fold BEFORE the snapshot (the leader's cadence
                # ordering): the fresh segment's position lands in the
                # snapshot's WAL coverage, so restarts replay the
                # folded suffix, not the removed segments
                self._compact_wal()
                if commit_service_snapshot(self.store, self.graph,
                                           self.refresher,
                                           self.records_applied):
                    self._edits_since_snapshot = 0
        return len(fresh)

    def poll_once(self) -> int:
        """One shipped chunk: fetch past the cursor, apply, advance +
        persist the cursor, refresh the lag gauges. Returns records
        received (the run loop keeps polling without delay while
        catching up). Raises on transport failure — the run loop owns
        backoff, and the cursor never advances on a failed poll."""
        from ..store.wal import decode_body, iter_frames

        if self._cursor is None:
            self._bootstrap()
            return 0
        t0 = time.perf_counter()
        out = self.ship.fetch_wal(self._cursor)
        self.polls += 1
        if out["gap"]:
            if self._cursor != (0, 0):
                # position compacted away while we were gone: re-tail
                # the folded log — everything we hold dedups
                self.gaps += 1
                trace.event("follower.ship_gap",
                            cursor=format_position(self._cursor),
                            restart=format_position(out["next"]))
            self._cursor = out["next"]
            self._persist_cursor()
            self.last_backlog = int(out["backlog"])
            return 0
        records = [decode_body(body)
                   for _, body in iter_frames(out["data"])]
        applied = self._apply_records(records)
        self._cursor = out["next"]
        try:
            self._persist_cursor()
        except (EigenError, OSError):
            # records are already in the local WAL; a stale cursor only
            # means a harmless dedup'd refetch after the next restart
            trace.event("follower.cursor_persist_failed")
        self.last_backlog = int(out["backlog"])
        trace.gauge("repl_lag_records").set(float(self.last_backlog))
        if out["eof"]:
            self._last_eof_at = time.time()
            self._refresh_bundle()
        trace.histogram("repl_poll_seconds").observe(
            time.perf_counter() - t0)
        return len(records)

    def _refresh_bundle(self) -> None:
        """Revalidate the cached leader bundle (If-None-Match — a 304
        in the steady state), at most once a second; never fatal (the
        bundle is an extra, the tail is the contract)."""
        now = time.monotonic()
        if now - self._bundle_checked_at < 1.0:
            return
        self._bundle_checked_at = now
        try:
            got = self.ship.fetch_bundle(
                self._bundle[1] if self._bundle else None)
        except EigenError:
            return
        if got is not None:
            self._bundle = got

    def repl_lag_seconds(self) -> float:
        """Seconds since this replica last saw the leader's committed
        tail (-1 before the first eof poll): the per-replica staleness
        bound — in steady state it reads under one poll interval."""
        if self._last_eof_at is None:
            return -1.0
        return time.time() - self._last_eof_at

    def run_tail(self, stop_event, poll_interval: float) -> None:
        """The ship-tail loop: the chain tailer's backoff discipline
        over :meth:`poll_once`, polling back-to-back while behind."""
        while not stop_event.is_set():
            self.beats.beat("ptpu-ship-tail")
            try:
                got = self.poll_once()
                self.consecutive_failures = 0
                delay = 0.0 if (got or self.last_backlog) \
                    else poll_interval
            except Exception:  # noqa: BLE001 - daemon thread: any
                # transport/decode failure backs off and retries; the
                # cursor only moves on success
                self.consecutive_failures += 1
                self.retries += 1
                delay = min(
                    self.config.backoff_base
                    * 2 ** (self.consecutive_failures - 1),
                    self.config.backoff_max)
                trace.event("follower.poll_failed",
                            failures=self.consecutive_failures,
                            backoff_s=delay)
            if delay:
                stop_event.wait(delay)

    # --- read-only HTTP surface -------------------------------------------
    def bundle_response(self) -> tuple | None:
        """The LEADER's signed bundle, served verbatim from cache: a
        replica cannot re-sign and must not — the signature chain is
        leader → client, the replica is just transport."""
        return self._bundle

    def proof_bytes(self, job_id: str):
        return None

    def score_freshness_seconds(self) -> float:
        return self.freshness.seconds(self.refresher.table.revision,
                                      time.time())

    def repl_status(self) -> dict:
        return {
            "leader": self.leader_url,
            "follower_id": self.follower_id,
            "cursor": (format_position(self._cursor)
                       if self._cursor else None),
            "lag_records": self.last_backlog,
            "lag_seconds": self.repl_lag_seconds(),
            "polls": self.polls,
            "gaps": self.gaps,
            "retries": self.retries,
            "consecutive_failures": self.consecutive_failures,
            "records_applied": self.records_applied,
            "bundle_cached": self._bundle is not None,
        }

    def health(self) -> dict:
        table = self.refresher.table
        wal = self.store.wal.stats()
        return {
            "ok": True,
            "role": "follower",
            "draining": self.draining,
            "leader": self.leader_url,
            "peers": self.graph.n,
            "edges": self.graph.n_edges,
            "revision": self.graph.revision,
            "score_revision": table.revision,
            "repl_lag_records": self.last_backlog,
            "repl_lag_seconds": self.repl_lag_seconds(),
            "uptime_s": (time.time() - self.started_at
                         if self.started_at else 0.0),
            "store": {
                "wal_segments": wal["segments"],
                "wal_bytes": wal["bytes"],
                "snapshots": self.store.snapshots.count(),
            },
        }

    def status(self) -> dict:
        table = self.refresher.table
        wal = self.store.wal.stats()
        return {
            "ok": True,
            "role": "follower",
            "draining": self.draining,
            "uptime_seconds": (time.time() - self.started_at
                               if self.started_at else 0.0),
            "graph": {
                "peers": self.graph.n,
                "edges": self.graph.n_edges,
                "revision": self.graph.revision,
                "invalid_attestations": self.graph.invalid,
            },
            "score_freshness_seconds": self.score_freshness_seconds(),
            "last_refresh": {
                "revision": table.revision,
                "iterations": table.iterations,
                "delta": table.delta,
                "cold": table.cold,
                "computed_at": table.computed_at,
                "refreshes": self.refresher.refreshes,
                "cold_refreshes": self.refresher.cold_refreshes,
            },
            "delta": self.refresher.delta_status(),
            "repl": self.repl_status(),
            "slo": self.slo.status(),
            "incidents": {
                "ring": len(self.recorder),
                "stalled_threads": self.watchdog.stalled(),
                "retained": len(self.incidents.list_ids()),
            },
            "store": {
                "wal_segments": wal["segments"],
                "wal_bytes": wal["bytes"],
                "wal_position": "%d:%d"
                                % self.store.wal.committed_position(),
                "snapshots": self.store.snapshots.count(),
                "snapshot_age_seconds":
                    self.store.snapshots.age_seconds(),
            },
            "xla": trace.compile_stats(),
        }

    def extra_metrics(self) -> dict:
        trace.gauge("score_freshness_seconds").set(
            self.score_freshness_seconds())
        trace.gauge("repl_lag_records").set(float(self.last_backlog))
        trace.gauge("repl_lag_seconds").set(self.repl_lag_seconds())
        out = {
            "service.up": 0.0 if self.draining else 1.0,
            "service.uptime_seconds": (time.time() - self.started_at
                                       if self.started_at else 0.0),
            "repl.records_applied": float(self.records_applied),
            "repl.polls": float(self.polls),
            "repl.gaps": float(self.gaps),
            "service.operator_cache_hits": float(
                self.refresher.operator_hits),
            "service.operator_builds": float(
                self.refresher.operator_builds),
        }
        out.update(self.store.metrics())
        return out

    def slo_status(self) -> dict:
        """``GET /slo`` on the replica: its own engine's evaluation."""
        return self.slo.status()

    def _fleet_summary(self) -> dict:
        """The role-specific digest the leader's ``/fleet`` renders."""
        lag = self.repl_lag_seconds()
        return {
            "leader": self.leader_url,
            "lag_records": self.last_backlog,
            "lag_seconds": lag if lag >= 0.0 else None,
            "records_applied": self.records_applied,
            "score_revision": self.refresher.table.revision,
        }

    def _incident_context(self) -> dict:
        """The follower's autopsy context (best-effort per item)."""
        from dataclasses import asdict

        from .metrics import render_prometheus

        ctx: dict = {}
        for name, build in (
                ("slo", self.slo.status),
                ("status", self.status),
                ("config", lambda: asdict(self.config)),
                ("metrics.txt", lambda: render_prometheus(
                    self.extra_metrics()))):
            try:
                ctx[name] = build()
            except Exception:  # noqa: BLE001 - a failing context
                pass           # getter must not void the bundle
        return ctx

    def _capture_incident(self, trigger: str, reason: str) -> str | None:
        return self.incidents.capture(
            trigger, reason, context=self._incident_context(),
            force=(trigger == "operator"))

    def _slo_tick(self) -> None:
        """Sample + evaluate this replica's SLOs (sentinel-honest:
        -1 freshness/lag means "no data"), at most once per
        ``slo_interval`` — threaded through the telemetry push loop."""
        # heartbeat every CALL (the pusher loop's cadence), before the
        # SLO-cadence early return below
        self.beats.beat("ptpu-telemetry")
        now = time.monotonic()
        if now - self._last_slo_tick < self.config.slo_interval:
            return
        self._last_slo_tick = now
        freshness = self.score_freshness_seconds()
        lag = self.repl_lag_seconds()
        gauges = {
            "score_freshness_seconds":
                freshness if freshness >= 0.0 else None,
            "repl_lag_seconds": lag if lag >= 0.0 else None,
        }
        age = self.beats.max_age()
        if age is not None:
            gauges["thread_heartbeat_age_max_seconds"] = age
        self.slo.sample(gauges=gauges)
        self.slo.evaluate()
        for name in self.slo.new_alerts():
            self.recorder.note("slo_latched", slo=name)
            self._capture_incident(
                "slo", f"SLO {name} latched (burn-rate alert tripped)")

    # --- lifecycle --------------------------------------------------------
    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> str:
        from .http_api import make_server

        if not trace.TRACER.enabled:
            trace.enable()
        self.started_at = time.time()
        import functools

        for name in ("ptpu-ship-tail", "ptpu-refresher",
                     "ptpu-telemetry"):
            self.beats.register(name)
        self.watchdog.start()
        t = threading.Thread(
            target=self.run_tail,
            args=(self._stop, self.config.poll_interval),
            daemon=True, name="ptpu-ship-tail")
        t.start()
        self._threads.append(t)
        t = threading.Thread(
            target=self.refresher.run,
            args=(self._stop, self._dirty, self.config.refresh_interval,
                  functools.partial(self.beats.beat, "ptpu-refresher")),
            daemon=True, name="ptpu-refresher")
        t.start()
        self._threads.append(t)
        # telemetry shipping: periodic instrument + span-window push
        # to the leader's /telemetry, with the SLO tick threaded
        # through the same loop (push failures back off, never bite)
        from .telemetry import TelemetryPusher

        pusher = TelemetryPusher(
            self.leader_url, self.instance, self.role,
            interval=self.config.telemetry_interval,
            collect=self.extra_metrics, summary=self._fleet_summary)
        t = threading.Thread(
            target=pusher.run, args=(self._stop,),
            kwargs={"tick": self._slo_tick},
            daemon=True, name="ptpu-telemetry")
        t.start()
        self._threads.append(t)
        self._server = make_server(self, self.config.host,
                                   self.config.port)
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ptpu-http")
        self._server_thread.start()
        trace.event("follower.started", url=self.url,
                    leader=self.leader_url)
        return self.url

    def shutdown(self, timeout: float | None = None) -> bool:
        if self.draining:
            return True
        self.draining = True
        timeout = self.config.drain_timeout if timeout is None \
            else timeout
        trace.event("follower.draining", timeout_s=timeout)
        self._stop.set()
        self._dirty.set()
        # watchdog first: a drain must never read as a thread stall
        self.watchdog.stop()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        for name in ("ptpu-ship-tail", "ptpu-refresher",
                     "ptpu-telemetry"):
            self.beats.unregister(name)
        clean = not any(t.is_alive() for t in self._threads)
        if clean:
            commit_service_snapshot(self.store, self.graph,
                                    self.refresher,
                                    self.records_applied)
        try:
            if self._cursor is not None:
                self._persist_cursor()
        except (EigenError, OSError):
            clean = False
        if clean:
            try:
                self.store.close()
            except OSError:
                clean = False
        self.drain_clean = clean
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server_thread.join(timeout=5.0)
        trace.event("follower.stopped", clean=clean)
        return clean

    def install_signal_handlers(self) -> None:
        import signal

        def _handle(signum, frame):
            trace.event("follower.signal", signum=signum)
            threading.Thread(target=self.shutdown, daemon=True,
                             name="ptpu-drain").start()

        signal.signal(signal.SIGTERM, _handle)
        signal.signal(signal.SIGINT, _handle)

    def wait(self, poll: float = 0.2) -> None:
        while not self._stop.is_set():
            time.sleep(poll)
        while self._server is not None and self._server_thread.is_alive():
            time.sleep(poll)
