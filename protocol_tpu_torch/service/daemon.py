"""The service supervisor: threads, lifecycle, durability, drain.

Thread layout (all daemon threads, all stopping on one event):

- **tailer** — ``ChainTailer.run``: poll chain → decode → sink;
- **refresher** — ``ScoreRefresher.run``: wake on dirty, converge,
  publish;
- **proof workers** — ``ProofWorkerPool``: one worker per device
  (``pool_workers`` overrides; host-path workers on CPU boxes), each
  with its own identity-keyed prover cache, cache-affinity scheduling
  and tiered load shedding (``pool.py``);
- **HTTP** — ``ThreadingHTTPServer`` (its own accept loop + per-request
  threads; GETs only read immutable snapshots).

The ingest sink is the only producer-side coupling, and — with a state
dir — the durability write path: it dedups the batch against everything
already logged, appends it to the attestation WAL (**append-before-
apply**: a failed append propagates, the cursor stays put, the tailer
refetches), recovers signer keys (batched on the card, scalar
otherwise), folds the batch into the opinion graph
AND the raw attestation buffer (the proof provers need the actual
signed attestations, not just edges), wakes the refresher, and every
``snapshot_every`` edits commits an atomic graph snapshot. The WAL is
NOT pruned on snapshot — format-2 snapshots persist only the WAL
coverage position and restore rebuilds the buffer from the log, so the
log is the attestation history; its growth is bounded by latest-wins
compaction instead (``store compact`` offline, or automatically at
startup once the log exceeds ``wal_compact_segments``).

Startup with a state dir is the reverse: restore the newest readable
snapshot (graph + published score table + attestation buffer), replay
the WAL from the snapshot's position, rehydrate persisted proof
artifacts into the job history, and resume the block cursor — a
SIGKILL'd daemon comes back serving identical scores without
re-fetching a single pre-cursor block, and its first refresh
warm-starts from the restored vector instead of a cold resync.

SIGTERM/SIGINT → :meth:`TrustService.shutdown`: mark draining (POSTs
503, health says so), stop the tailer/refresher, drain the job queue
within ``drain_timeout``, take a farewell snapshot (making the next
start's replay trivial), persist the cursor one last time, then stop
HTTP. The cursor is already persisted per poll and the WAL per batch,
so even a SIGKILL loses at most one poll's worth of re-fetchable logs.
"""

from __future__ import annotations

import os
import threading
import time

from ..client.attestation import DOMAIN_PREFIX, SignedAttestationData
from ..utils import trace
from ..utils.checkpoint import CheckpointManager
from ..utils.errors import EigenError
from .config import ServiceConfig
from .faults import FaultInjector
from .pool import ProofWorkerPool
from .refresh import ScoreRefresher, ScoreTable
from .state import (
    FreshnessTracker,
    OpinionGraph,
    att_digest,
    recover_signers,
    trace_id_of,
)
from .tailer import ChainTailer

# the dedup key (see state.att_digest: block + about + normalized
# payload — the block matters because RFC 6979 re-attestations are
# byte-identical in payload)
_att_digest = att_digest


def commit_service_snapshot(store, graph, refresher,
                            n_attestations: int) -> bool:
    """One consistent cut → atomic snapshot: the shared core of the
    leader's and the follower's snapshot paths (the follower replays
    the SAME store formats, so its durability discipline is this exact
    code, not a reimplementation). Must run on the sink thread — the
    only graph/WAL mutator — or after it stopped. The WAL is synced
    first: the snapshot claims coverage up to ``position()``, and
    under ``wal_fsync="never"`` those bytes may be page-cache only."""
    from ..store import encode_service_state

    n, src, dst, val, revision, edits = graph.snapshot()
    addrs = graph.addresses()[:n]
    invalid = graph.invalid
    try:
        store.wal.sync()
    except OSError:
        store.snapshot_failures += 1
        trace.event("service.snapshot_failed", revision=revision)
        return False
    pos = store.wal.position()
    arrays, meta = encode_service_state(
        addrs, src, dst, val, revision, edits, invalid,
        refresher.table, pos, n_attestations=n_attestations)
    try:
        with trace.span("service.snapshot", revision=revision,
                        n=len(addrs), attestations=n_attestations):
            store.snapshots.save(revision, arrays, meta)
    except (EigenError, OSError):
        # OSError too: CheckpointManager raises raw ENOSPC/EIO, and
        # the farewell snapshot on the drain path must degrade to
        # "longer replay next start", never abort the shutdown
        store.snapshot_failures += 1
        trace.event("service.snapshot_failed", revision=revision)
        return False
    trace.metric("service.snapshot_revision", revision)
    return True


class TrustService:
    """Wire-up + lifecycle for one service instance."""

    def __init__(self, client, config: ServiceConfig, checkpoint_dir: str,
                 provers: dict | None = None, backend=None,
                 faults: FaultInjector | None = None, files=None,
                 state_dir: str | None = None):
        """``client``: a ``client.Client`` (chain + domain + circuit
        hyperparameters); ``checkpoint_dir``: block-cursor durability;
        ``provers``: job registry (default: the production
        EigenTrust/Threshold provers over ``files``' assets);
        ``state_dir`` (or ``config.state_dir``): root of the durable
        state store — WAL, snapshots, proof artifacts, operator cache —
        omitted, the graph and proof history are memory-only and only
        the cursor survives a restart."""
        self.client = client
        self.config = config
        self.faults = faults or FaultInjector()
        if not trace.TRACER.enabled:
            # /metrics is part of the service contract, and restore
            # (snapshot + WAL replay) emits spans before start()
            trace.enable()
        # instrument families declared up front (# TYPE from the first
        # scrape); the compile listener is the tracer's no-op on torch,
        # kept so /status carries the same "xla" block
        from .metrics import declare_instruments

        declare_instruments()
        trace.install_compile_tracking()
        state_dir = state_dir or config.state_dir or None
        # fleet identity: stamped on every trace record this process
        # emits and carried by ptpu_build_info from the first scrape
        import hashlib

        from .slo import SloEngine
        from .telemetry import TelemetryRegistry, set_build_info

        if config.instance_id:
            self.instance = config.instance_id
        elif state_dir:
            self.instance = "ldr-" + hashlib.sha256(
                os.path.abspath(str(state_dir)).encode()).hexdigest()[:8]
        else:
            self.instance = f"ldr-{os.getpid()}"
        self.role = "leader"
        set_build_info(self.instance, self.role)
        # the leader-side fleet plane: TTL'd per-instance telemetry
        # registry + the SLO burn-rate engine over fleet-wide gauges
        self.telemetry = TelemetryRegistry(ttl=config.telemetry_ttl)
        self.slo = SloEngine(fast_window=config.slo_fast_window,
                             slow_window=config.slo_slow_window)
        # the incident plane: an always-on flight-recorder
        # ring, per-thread heartbeats + the stall watchdog, and — with
        # a state dir — the rate-limited autopsy-bundle store under
        # <state-dir>/incidents (memory-only daemons keep the ring and
        # the watchdog; there is just nowhere durable to freeze it)
        from .recorder import FlightRecorder, IncidentStore
        from .watchdog import Heartbeats, StallWatchdog

        self.recorder = FlightRecorder(cap=config.incident_ring_cap)
        self.beats = Heartbeats()
        self.incidents = (IncidentStore(
            os.path.join(str(state_dir), "incidents"), self.recorder,
            retention=config.incident_retention,
            min_interval=config.incident_min_interval)
            if state_dir else None)
        self.watchdog = StallWatchdog(
            self.beats, recorder=self.recorder, store=self.incidents,
            interval=config.watchdog_interval,
            stall_after=config.watchdog_stall_after)
        if self.incidents is not None:
            # the getattr-gated HTTP surfaces (absent → 404, the same
            # pattern as the fleet registry on a follower)
            self.incident_index = self.incidents.index
            self.incident_bundle = self.incidents.load
            self.incident_capture = self._capture_incident
        self.store = None
        if state_dir:
            from ..store import StateStore

            proofs_dir = (str(files.proofs_dir())
                          if files is not None else None)
            self.store = StateStore(
                str(state_dir), segment_bytes=config.wal_segment_bytes,
                fsync=config.wal_fsync, snapshot_keep=config.snapshot_keep,
                faults=self.faults, proofs_dir=proofs_dir)
        self.graph = OpinionGraph()
        # trace join seam: the sink records each applied attestation's
        # trace id at its graph revision; the refresher takes everything
        # at-or-below the revision it publishes, stamping the refresh
        # span that first reflects those attestations in served scores
        self.pending_traces = trace.PendingTraces()
        # the refresher converges on the client's device (None: the
        # card), the same device the batched signer recovery uses
        self.refresher = ScoreRefresher(
            self.graph, config, backend=backend, faults=self.faults,
            operator_cache_dir=(self.store.operators_dir
                                if self.store else None),
            pending_traces=self.pending_traces,
            recorder=self.recorder, device=client.device)
        self._attestations: list = []
        self._att_blocks: list = []  # parallel: block number per entry
        # (snapshots persist them so restart dedup keys stay exact)
        self._att_lock = threading.Lock()
        self._seen: set = set()
        self._edits_since_snapshot = 0
        # freshness tracking: (graph revision after apply, wall-clock of
        # the newest attestation in that batch). score_freshness_seconds
        # = now − the newest timestamp whose revision the published
        # table covers — the end-to-end ingest→served-scores lag
        self.freshness = FreshnessTracker()
        # read-path scale-out: the leader side of WAL segment shipping
        # (followers tail /repl/wal; compaction respects their floor)
        # and the signed score bundle cache (rebuilt per published
        # table identity + latest ET proof id; RFC 6979 signing keeps
        # an unchanged bundle byte-identical, so the ETag is strong)
        self.repl_source = None
        if self.store is not None:
            from .replication import ReplicationSource

            self.repl_source = ReplicationSource(
                self.store, follower_ttl=config.repl_follower_ttl)
        self._bundle_lock = threading.Lock()
        # (table ref, proof_id, body, etag) — see bundle_response
        self._bundle_cache: tuple | None = None
        if self.store is not None:
            self._restore()
        self.tailer = ChainTailer(
            client.chain, client._domain_bytes(), self._sink,
            CheckpointManager(checkpoint_dir, keep=config.cursor_keep),
            faults=self.faults, backoff_base=config.backoff_base,
            backoff_max=config.backoff_max)
        if self.store is not None:
            # after restore (the in-memory _seen covers the whole
            # uncompacted log, so the suffix the tailer will refetch
            # dedups either way) and after the tailer restored the
            # persisted cursor (the fold floor)
            self._compact_wal(self.tailer.persisted_cursor)
        self._ident_digest: tuple | None = None  # (revision, digest)
        from .provers import (
            PROOF_PRIORITIES,
            PROOF_SHARD_EXEMPT,
            make_cache_key_fn,
            make_provers,
            make_worker_env,
        )

        cache_key_fn = None
        if provers is None:
            if files is None:
                raise EigenError(
                    "config_error",
                    "need an EigenFile assets layout (files=) to build "
                    "the default provers, or pass provers= explicitly")
            # the default registry: eigentrust and threshold proofs and
            # the capture window. Its affinity keys carry (kind, k,
            # identity-set digest); injected registries keep kind-keyed
            # affinity (the pool's default)
            provers = make_provers(self, files,
                                   shape_name=config.proof_shape,
                                   transcript=config.transcript)
            cache_key_fn = make_cache_key_fn(
                self, shape_name=config.proof_shape)
        # cross-process proving fabric (opt-in + needs durable state:
        # the fabric directory IS the worker rendezvous substrate, and
        # a memory-only daemon has no filesystem to share)
        self.fabric = None
        # filesystem-transport prove-workers drop their telemetry
        # reports here (atomic rename); the observer thread sweeps it
        self._telemetry_drop = (os.path.join(str(state_dir), "fabric",
                                             "telemetry")
                                if state_dir else None)
        if config.fabric and state_dir:
            from ..zk.fabric import FabricStore

            self.fabric = FabricStore(
                os.path.join(str(state_dir), "fabric"),
                lease_ttl=config.fabric_lease_ttl, faults=self.faults)
        self.jobs = ProofWorkerPool(
            provers, capacity=config.queue_capacity, faults=self.faults,
            artifacts=self.store.artifacts if self.store else None,
            workers=config.pool_workers or None,
            priorities=PROOF_PRIORITIES,
            watermark=config.shed_watermark,
            queue_bytes=config.queue_bytes,
            worker_env=make_worker_env(self),
            cache_key_fn=cache_key_fn,
            # every prover kind except the capture window is shardable
            # (PROOF_SHARD_EXEMPT) — injected test registries included,
            # so the smoke's deterministic provers shard like the real
            # eigentrust/threshold ones
            shard_kinds=(set(provers) - PROOF_SHARD_EXEMPT
                         if config.shard_proves else None),
            shard_cap=config.shard_cap,
            fabric=self.fabric)
        if self.store is not None:
            rehydrated = self.jobs.rehydrate()
            if rehydrated:
                trace.event("service.jobs_rehydrated", n=rehydrated)
        self._stop = threading.Event()
        self._dirty = threading.Event()
        if self.store is not None and self.refresher.stale():
            self._dirty.set()  # replay outran the snapshot's table:
            # warm-refresh the gap as soon as the refresher starts
        self._threads: list = []
        self._server = None
        self._server_thread = None
        self.started_at: float | None = None
        self.draining = False
        self.drain_clean: bool | None = None  # set by shutdown()

    # --- durability: restore ----------------------------------------------
    def _decode_record(self, about: bytes, payload: bytes):
        """WAL/snapshot record → SignedAttestationData via the exact
        codec the tailer uses; None for undecodable bytes (never fatal:
        the log can hold what an attacker emitted at our key)."""
        key = DOMAIN_PREFIX + self.client._domain_bytes()
        try:
            return SignedAttestationData.from_log(about, key, payload)
        except EigenError:
            return None

    def _compact_wal(self, cursor_floor: int) -> None:
        """WAL compaction — the daemon-side twin of the offline
        ``store compact`` verb, since format-2 snapshots stopped
        pruning the log (it IS the attestation history now): once the
        WAL holds ``wal_compact_segments`` segments, fold latest-wins
        duplicates per recovered ``(signer, about)`` into a fresh
        segment. Runs after restore (constructor path, once the tailer
        holds the persisted cursor — compacting BEFORE restore would
        pay the full-log signer recovery twice, since every folded
        record lands past the snapshot's covered position) AND from
        the periodic snapshot cadence (sink thread — the only WAL
        writer, so no append can race the fold), bounding log growth
        for long-lived daemons. The fresh segment's index is past
        every old one, so a snapshot position into a removed segment
        simply re-applies the folded records — latest-wins and
        order-preserving, identical state.

        ``cursor_floor``: records with ``block > cursor_floor`` are
        NEVER folded (each keeps a unique key). The tailer refetches
        blocks past the persisted cursor after a crash, deduping them
        against ``_seen`` — which a future restart rebuilds from this
        log. Folding a superseded record above the floor would delete
        exactly the digest that dedups its refetch: the stale value
        would re-apply while the surviving newer record is skipped,
        silently reverting the edge. Below the floor the tailer can
        never refetch, so folding is safe.

        Signer recovery batches through the ingest pipeline (the same
        cost class one restore pass pays). Never fatal: a failed
        compaction degrades to a bigger log."""
        lim = self.config.wal_compact_segments
        if lim <= 0 or len(self.store.wal.segments()) < lim:
            return
        if self.repl_source is not None and self.repl_source.catching_up():
            # the SHIP FLOOR (the replication twin of the cursor
            # floor): compaction rewrites every segment, invalidating
            # all shipped positions — folding now would force a
            # catch-up follower to restart the tail it is mid-way
            # through. Defer until active followers reach the tail;
            # followers AT the tail just re-tail the folded log once
            # (content dedup skips everything they hold), and
            # followers past the TTL don't pin the log.
            trace.event("service.wal_compact_deferred",
                        reason="follower_catching_up")
            return
        try:
            records = [(blk, about, payload,
                        self._decode_record(about, payload))
                       for blk, about, payload in self.store.wal.replay()]
            decoded = [r[3] for r in records if r[3] is not None]
            signers = recover_signers(
                decoded, batched=self.client.batched_ingest,
                device=self.client.device)
            it = iter(signers)
            key_map = {}
            for blk, about, payload, signed in records:
                if signed is None:
                    continue
                signer = next(it)
                if signer is None:
                    continue  # unrecoverable: replay rejects it anyway
                if blk > cursor_floor:  # refetchable: keep verbatim
                    key_map[(blk, about, payload)] = (
                        "nofold", blk, about, payload)
                else:
                    key_map[(blk, about, payload)] = (signer, about)
            with trace.span("service.wal_compact", records=len(records),
                            cursor_floor=cursor_floor):
                out = self.store.wal.compact(
                    lambda b, a, p: key_map.get((b, a, p)))
            trace.event("service.wal_compacted",
                        records_in=out["records_in"],
                        records_out=out["records_out"],
                        segments_removed=out["segments_removed"])
        except (EigenError, OSError):
            trace.event("service.wal_compact_failed")

    def _restore(self) -> None:
        """Snapshot restore + WAL replay (constructor path, before any
        thread exists — no locks contended)."""
        from ..store import decode_service_state

        t0 = time.monotonic()
        restored_revision = -1
        loaded = self.store.snapshots.load_latest()
        wal_start = None
        buffer_from_wal = True
        if loaded is not None:
            _, arrays, meta = loaded
            st = decode_service_state(arrays, meta)
            self.graph.restore_state(st["addrs"], st["edges"],
                                     st["revision"],
                                     st["edits_since_cold"],
                                     st["invalid"])
            score_n = len(st["scores"])
            self.refresher.install(ScoreTable(
                addresses=tuple(st["addrs"][:score_n]),
                scores=st["scores"], revision=st["score_revision"],
                iterations=st["iterations"], delta=st["delta"],
                cold=st["cold"], computed_at=st["computed_at"]))
            if st["buffer_in_snapshot"]:
                # format-1 snapshot (the older layout): the raw buffer rides in
                # the snapshot itself; replay only the uncovered suffix
                buffer_from_wal = False
                for blk, about, payload in st["att_records"]:
                    signed = self._decode_record(about, payload)
                    if signed is None:
                        continue
                    self._attestations.append(signed)
                    self._att_blocks.append(blk)
                    self._seen.add(_att_digest(blk, about, payload))
            restored_revision = st["revision"]
            wal_start = st["wal_pos"]
        batch = []
        batch_blocks = []
        if buffer_from_wal:
            # format 2: snapshots persist WAL COVERAGE, not the buffer
            # (O(graph) encode, so it no longer grows with the history). One
            # pass over the full (compacted) log rebuilds the raw
            # attestation buffer; only records PAST the covered
            # position apply to the graph — signer recovery, the
            # expensive part, stays O(uncovered suffix). After a
            # compaction the covered position's segment is gone and
            # every folded record re-applies; the graph is latest-wins
            # and the replay is order-preserving, so that folds to the
            # identical state.
            for pos, (blk, about, payload) in \
                    self.store.wal.replay_frames():
                digest = _att_digest(blk, about, payload)
                if digest in self._seen:
                    continue
                signed = self._decode_record(about, payload)
                if signed is None:
                    continue
                self._seen.add(digest)
                self._attestations.append(signed)
                self._att_blocks.append(blk)
                if wal_start is None or pos > wal_start:
                    batch.append(signed)
                    batch_blocks.append(blk)
        else:
            # replay everything past the snapshot's position; dedup by
            # content makes any overlap harmless
            for blk, about, payload in self.store.wal.replay(wal_start):
                digest = _att_digest(blk, about, payload)
                if digest in self._seen:
                    continue
                signed = self._decode_record(about, payload)
                if signed is None:
                    continue
                self._seen.add(digest)
                batch.append(signed)
                batch_blocks.append(blk)
        if batch:
            signers = recover_signers(
                batch, batched=self.client.batched_ingest,
                device=self.client.device)
            self.graph.apply(batch, signers)
            if not buffer_from_wal:
                self._attestations.extend(batch)
                self._att_blocks.extend(batch_blocks)
        self.store.replayed_records = len(batch)
        trace.event("service.restored",
                    snapshot_revision=restored_revision,
                    replayed=len(batch), peers=self.graph.n,
                    edges=self.graph.n_edges,
                    seconds=round(time.monotonic() - t0, 3))

    # --- durability: snapshot ---------------------------------------------
    def _take_snapshot(self, compact: bool = True) -> bool:
        """Periodic/farewell snapshot (the shared core is
        :func:`commit_service_snapshot`). ``compact=True`` (the
        periodic cadence; sink thread = the only WAL writer, so the
        fold can't race an append) first bounds a long-lived daemon's
        log growth the way the startup pass bounds it across restarts.
        The fold floor is the last cursor KNOWN ON DISK — the
        in-memory cursor can run ahead when a persist fails, and
        folding a record a post-crash refetch could re-deliver would
        delete the digest that dedups it. ``compact=False`` on the
        drain path: a farewell snapshot must not spend the
        drain_timeout budget re-recovering signers — the next start
        compacts."""
        if compact:
            self._compact_wal(self.tailer.persisted_cursor)
        with self._att_lock:
            n_atts = len(self._attestations)
        ok = commit_service_snapshot(self.store, self.graph,
                                     self.refresher, n_atts)
        if ok:
            self._edits_since_snapshot = 0
        return ok

    # --- ingest sink ------------------------------------------------------
    def _sink(self, batch: list, block: int, blocks: list | None = None) \
            -> None:
        fresh = []
        if self.store is not None:
            for k, signed in enumerate(batch):
                about = signed.attestation.about
                payload = signed.to_payload()
                blk = blocks[k] if blocks else block
                digest = _att_digest(blk, about, payload)
                if digest in self._seen:
                    continue  # already logged (replayed batch whose
                    # cursor checkpoint lost the race with the crash)
                fresh.append((signed, digest, about, payload, blk))
            if not fresh:
                return
            with trace.span("service.wal_append", n=len(fresh),
                            block=block):
                self.store.wal.append(
                    [(blk, about, payload)
                     for _, _, about, payload, blk in fresh])
            batch = [signed for signed, _, _, _, _ in fresh]
        with trace.span("service.ingest", n=len(batch), block=block):
            signers = recover_signers(batch,
                                      batched=self.client.batched_ingest,
                                      device=self.client.device)
        with self._att_lock:
            self._attestations.extend(batch)
            if self.store is not None:
                self._att_blocks.extend(blk for _, _, _, _, blk in fresh)
        with trace.span("service.graph_apply", n=len(batch), block=block):
            changed = self.graph.apply(batch, signers)
        if self.store is not None:
            # marked seen only now: if recovery/apply had failed after
            # the append, the refetched batch must NOT be deduped away —
            # it re-appends (replay folds the duplicate) and re-applies
            for _, digest, _, _, _ in fresh:
                self._seen.add(digest)
            tids = [trace_id_of(digest) for _, digest, _, _, _ in fresh]
        else:
            # memory-only: the tailer's context carries the batch ids
            tids = list(trace.current_trace_ids())
        if tids:
            self.pending_traces.add(self.graph.revision, tids)
        self.freshness.record(self.graph.revision, time.time())
        self._dirty.set()
        if self.store is not None and changed:
            self._edits_since_snapshot += changed
            if self._edits_since_snapshot >= self.config.snapshot_every:
                self._take_snapshot()  # failure-tolerant: counted, and
                # the edit counter keeps accruing so it retries soon

    def attestation_snapshot(self) -> list:
        with self._att_lock:
            return list(self._attestations)

    def identity_digest(self) -> str:
        """Digest of the current participant set: the identity-set
        component of the proof pool's affinity cache keys. Cached per
        graph revision, so a submit costs a tuple compare, not a hash
        over every peer; the graph's interning is append-only, so a
        stale read racing an apply at worst keys one job to the previous
        set (an affinity miss, never an error)."""
        from .provers import identity_digest_of

        rev = self.graph.revision
        cached = self._ident_digest
        if cached is not None and cached[0] == rev:
            return cached[1]
        digest = identity_digest_of(self.graph.addresses())
        self._ident_digest = (rev, digest)
        return digest

    # --- proof artifacts --------------------------------------------------
    def proof_bytes(self, job_id: str) -> bytes | None:
        """Raw proof for ``GET /proofs/<id>/proof.bin``: the persisted
        artifact when a store is wired (survives MRU eviction and
        restarts), else the in-memory result's proof hex."""
        if self.store is not None:
            data = self.store.artifacts.proof_bytes(job_id)
            if data is not None:
                return data
        job = self.jobs.get(job_id)
        if job is None or not isinstance((job.result or {}).get("proof"),
                                         str):
            return None
        try:
            return bytes.fromhex(job.result["proof"])
        except ValueError:
            return None

    # --- signed score bundle ----------------------------------------------
    def bundle_response(self) -> tuple | None:
        """``(body_bytes, etag)`` for ``GET /bundle``: the canonical
        signed bundle of the CURRENT published table + the newest done
        EigenTrust proof id, cached per (table identity, proof id) —
        steady-state reads are a dict hit, and RFC 6979 signing makes
        the rebuild after a refresh byte-stable for its content, so
        the ETag is a strong validator edges/CDNs can revalidate
        against with ``If-None-Match``. None before the first publish
        (there is nothing to sign yet)."""
        import json

        from ..client.eth import address_from_public_key
        from .bundle import bundle_json, encode_bundle_payload, \
            sign_bundle

        table = self.refresher.table
        if table.revision < 0:
            return None
        proof_id = self.jobs.latest_done("eigentrust") or ""
        with self._bundle_lock:
            cached = self._bundle_cache
            # identity by reference, with the table HELD in the cache
            # tuple: a bare id() key could collide after the old table
            # is collected and a new one reuses its address, silently
            # serving a stale signed bundle
            if cached is not None and cached[0] is table \
                    and cached[1] == proof_id:
                return cached[2], cached[3]
        wal_pos = (self.store.wal.committed_position()
                   if self.store is not None else (0, 0))
        signer = self.client.signer
        leader = address_from_public_key(signer.public_key)
        payload = encode_bundle_payload(
            leader, table.revision, wal_pos, table.digest,
            len(table.addresses), table.computed_at, proof_id)
        signature = sign_bundle(signer, payload)
        body = json.dumps(bundle_json(payload, signature)).encode()
        # the payload digest IS the validator: any signed byte changing
        # (table, proof id, signing position) changes it, and a
        # restarted leader rebuilding the identical bundle reproduces
        # it (RFC 6979) — process-stable, unlike hash()
        import hashlib

        etag = f'"bndl-{hashlib.sha256(payload).hexdigest()[:24]}"'
        with self._bundle_lock:
            self._bundle_cache = (table, proof_id, body, etag)
        return body, etag

    # --- introspection ----------------------------------------------------
    def score_freshness_seconds(self) -> float:
        """Now − arrival time of the newest attestation REFLECTED in the
        served score table (the chain clients carry no block timestamps,
        so sink wall-clock is the block-time proxy): the end-to-end
        ingest→refresh→served lag. -1.0 until the first attestation is
        both ingested and published (the gauge is always present but
        clearly 'never')."""
        return self.freshness.seconds(self.refresher.table.revision,
                                      time.time())

    def status(self) -> dict:
        """``GET /status``: one JSON page an operator (or a dashboard's
        sidecar) reads instead of joining five /metrics series —
        uptime, cursor position, graph size, score freshness, queue
        depths, and the last refresh's convergence stats."""
        table = self.refresher.table
        out = {
            "ok": True,
            "draining": self.draining,
            "uptime_seconds": (time.time() - self.started_at
                               if self.started_at else 0.0),
            "block_cursor": self.tailer.cursor,
            "tailer": {
                "batches": self.tailer.batches,
                "attestations": self.tailer.attestations,
                "skipped": self.tailer.skipped,
                "retries": self.tailer.retries,
                "consecutive_failures": self.tailer.consecutive_failures,
            },
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
            # incremental operator maintenance: is a delta engine
            # anchored, how much churn has it absorbed in place, and
            # how dirty is the patched operator vs its anchor build
            "delta": self.refresher.delta_status(),
            "queue": {
                "depth": self.jobs.depth(),
                "completed": self.jobs.completed,
                "failed": self.jobs.failed,
            },
            # the proof pool: per-worker rows (queue depth, running
            # job, affinity hits/misses, resident cache keys) plus the
            # admission state (watermark, byte budget, shed counts)
            "pool": self.jobs.pool_status(),
            # device-layer observability: compile counts and the
            # steady-state recompile latch (a warning here means a
            # shape leak in the refresh or prover cache — see
            # trace.CompileTracker)
            "xla": trace.compile_stats(),
        }
        if self.store is not None:
            wal = self.store.wal.stats()
            out["store"] = {
                "wal_segments": wal["segments"],
                "wal_bytes": wal["bytes"],
                "wal_position": "%d:%d"
                                % self.store.wal.committed_position(),
                "snapshots": self.store.snapshots.count(),
                "snapshot_age_seconds":
                    self.store.snapshots.age_seconds(),
                "replayed_records": self.store.replayed_records,
                "proof_artifacts": self.store.artifacts.count(),
            }
        if self.repl_source is not None:
            # the shipping side: per-follower positions + eof, totals
            out["repl"] = self.repl_source.status()
        # the SLO engine's last evaluation: burn per window, in-budget
        # flags, and the LATCHED alerts (stay up until both windows
        # recover) — the /status face of /slo
        out["slo"] = self.slo.status()
        # the incident plane: ring occupancy, currently-stalled
        # threads, and (with a store) how many bundles are retained
        out["incidents"] = {
            "ring": len(self.recorder),
            "stalled_threads": self.watchdog.stalled(),
            "retained": (len(self.incidents.list_ids())
                         if self.incidents is not None else None),
        }
        return out

    def health(self) -> dict:
        table = self.refresher.table
        out = {
            "ok": True,
            "draining": self.draining,
            "block_cursor": self.tailer.cursor,
            "peers": self.graph.n,
            "edges": self.graph.n_edges,
            "revision": self.graph.revision,
            "score_revision": table.revision,
            "queue_depth": self.jobs.depth(),
            "uptime_s": (time.time() - self.started_at
                         if self.started_at else 0.0),
        }
        if self.store is not None:
            wal = self.store.wal.stats()
            out["store"] = {
                "wal_segments": wal["segments"],
                "wal_bytes": wal["bytes"],
                "snapshots": self.store.snapshots.count(),
                "replayed_records": self.store.replayed_records,
                "proof_artifacts": self.store.artifacts.count(),
            }
        return out

    def extra_metrics(self) -> dict:
        """Service-local gauges merged into /metrics (things the tracer
        does not carry because they are state, not samples)."""
        # refreshed per scrape: the typed gauge is what dashboards
        # alert on (ptpu_score_freshness_seconds)
        trace.gauge("score_freshness_seconds").set(
            self.score_freshness_seconds())
        if self.fabric is not None:
            # fabric fleet state is filesystem state, not samples —
            # refreshed per scrape like freshness above. A stuck lease
            # age (sawtooth never resetting) is the SIGKILLed-worker
            # signature before leases_expired even moves.
            try:
                trace.gauge("fabric_workers").set(
                    float(self.fabric.workers_live()))
                trace.gauge("fabric_lease_age_seconds").set(
                    float(self.fabric.oldest_lease_age()))
            except Exception:  # noqa: BLE001 - scrape must not 500
                pass
        out = {
            "service.up": 0.0 if self.draining else 1.0,
            "service.queue_depth": float(self.jobs.depth()),
            "service.proof_completed": float(self.jobs.completed),
            "service.proof_failed": float(self.jobs.failed),
            "service.operator_cache_hits": float(
                self.refresher.operator_hits),
            "service.operator_builds": float(
                self.refresher.operator_builds),
            "service.delta_batches": float(
                self.refresher.delta_batches),
            "service.partial_refreshes": float(
                self.refresher.partial_refreshes),
            "service.delta_reanchors": float(
                self.refresher.delta_reanchors),
            "service.uptime_seconds": (time.time() - self.started_at
                                       if self.started_at else 0.0),
        }
        if self.store is not None:
            out.update(self.store.metrics())
        return out

    # --- fleet observability ----------------------------------------------
    def telemetry_report(self, obj: dict) -> dict:
        """``POST /telemetry``: ingest one non-leader snapshot."""
        return self.telemetry.report(obj)

    def _local_fleet_row(self) -> dict:
        from .. import __version__

        freshness = self.score_freshness_seconds()
        return {
            "instance": self.instance,
            "role": self.role,
            "version": __version__,
            # sentinel-honest: -1 pre-publish means "no data", never
            # a negative freshness sample
            "score_freshness_seconds":
                freshness if freshness >= 0.0 else None,
            "repl_lag_seconds": None,
            "summary": {
                "queue_depth": self.jobs.depth(),
                "graph_revision": self.graph.revision,
                "score_revision": self.refresher.table.revision,
                "fabric_workers": (self.fabric.workers_live()
                                   if self.fabric is not None else 0),
                "followers": (len(self.repl_source.status()
                                  .get("followers", []))
                              if self.repl_source is not None else 0),
            },
        }

    def fleet_status(self) -> dict:
        """``GET /fleet``: per-instance operator rows, leader first."""
        from .telemetry import fleet_rows

        return fleet_rows(self.telemetry, self._local_fleet_row())

    def fleet_metrics(self) -> str:
        """``GET /fleet/metrics``: the federated exposition page."""
        from .telemetry import render_fleet_metrics, update_fleet_gauges

        update_fleet_gauges(self.telemetry)
        return render_fleet_metrics(self.telemetry, self.instance,
                                    self.role,
                                    extra=self.extra_metrics())

    def slo_status(self) -> dict:
        """``GET /slo``: the engine's latest evaluation."""
        return self.slo.status()

    # --- incident plane -----------------------------------------------------
    def _incident_context(self) -> dict:
        """Everything an autopsy wants frozen alongside the ring: SLO
        window state, the full operator status page, fleet rows, the
        effective config, and the metrics exposition as text. Each
        item best-effort — a sick subsystem is exactly when captures
        happen, and a failing context getter must not void the bundle."""
        from dataclasses import asdict

        from .metrics import render_prometheus
        from .telemetry import fleet_rows

        ctx: dict = {}
        for name, build in (
                ("slo", self.slo.status),
                ("status", self.status),
                ("config", lambda: asdict(self.config)),
                ("fleet", lambda: fleet_rows(self.telemetry,
                                             self._local_fleet_row())),
                ("metrics.txt", lambda: render_prometheus(
                    self.extra_metrics()))):
            try:
                ctx[name] = build()
            except Exception:  # noqa: BLE001 - see docstring
                pass
        return ctx

    def _capture_incident(self, trigger: str, reason: str) -> str | None:
        """SLO-latch / operator-POST capture with full daemon context;
        operator captures bypass the rate limit (a human asked)."""
        if self.incidents is None:
            return None
        return self.incidents.capture(
            trigger, reason, context=self._incident_context(),
            force=(trigger == "operator"))

    def _observe(self, stop: threading.Event) -> None:
        """The observer thread: sweep file-dropped worker telemetry,
        refresh the fleet and device-memory gauges, and tick the SLO
        engine over the fleet-wide (sentinel-honest) gauge view."""
        from .recorder import update_device_memory_gauges
        from .telemetry import fleet_gauge_view, update_fleet_gauges

        interval = max(0.05, min(self.config.slo_interval,
                                 self.config.telemetry_interval))
        prev_alerts: set = set()
        while not stop.is_set():
            self.beats.beat("ptpu-observer")
            try:
                if self._telemetry_drop is not None:
                    self.telemetry.sweep_dir(self._telemetry_drop)
                update_fleet_gauges(self.telemetry)
                update_device_memory_gauges()
                freshness = self.score_freshness_seconds()
                local = {"score_freshness_seconds":
                         freshness if freshness >= 0.0 else None}
                gauges = fleet_gauge_view(self.telemetry, local=local)
                # feed the thread_stall SLO: the watchdog exports the
                # per-thread gauges, the engine burns on the fleet max
                age = self.beats.max_age()
                if age is not None:
                    gauges["thread_heartbeat_age_max_seconds"] = age
                self.slo.sample(gauges=gauges)
                self.slo.evaluate()
                # SLO transitions into the ring; a NEW latch freezes
                # it into a bundle (rate-limited by the store)
                for name in self.slo.new_alerts():
                    self.recorder.note("slo_latched", slo=name)
                    self._capture_incident(
                        "slo", f"SLO {name} latched "
                               "(burn-rate alert tripped)")
                cur = {r["slo"] for r in self.slo.status()["slos"]
                       if r["alerting"]}
                for name in sorted(prev_alerts - cur):
                    self.recorder.note("slo_released", slo=name)
                prev_alerts = cur
            except Exception:  # noqa: BLE001 - observability must not
                pass           # take the service down
            stop.wait(interval)

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    # --- lifecycle --------------------------------------------------------
    def start(self) -> str:
        """Start all threads + the HTTP listener; returns the base URL.
        Tracing is force-enabled (in-memory, since the constructor) —
        /metrics is part of the service contract, not an opt-in."""
        from .http_api import make_server

        if not trace.TRACER.enabled:
            trace.enable()  # e.g. the CLI's --trace teardown ran between
        self.started_at = time.time()
        self.jobs.start(beats=self.beats)
        # register every long-lived loop BEFORE its thread starts, so
        # a thread that wedges on its very first iteration still reads
        # as a stall rather than never existing; then the watchdog
        import functools

        for name in ("ptpu-tailer", "ptpu-refresher", "ptpu-observer"):
            self.beats.register(name)
        self.watchdog.start()
        t = threading.Thread(
            target=self.tailer.run,
            args=(self._stop, self.config.poll_interval,
                  functools.partial(self.beats.beat, "ptpu-tailer")),
            daemon=True, name="ptpu-tailer")
        t.start()
        self._threads.append(t)
        t = threading.Thread(
            target=self.refresher.run,
            args=(self._stop, self._dirty, self.config.refresh_interval,
                  functools.partial(self.beats.beat, "ptpu-refresher")),
            daemon=True, name="ptpu-refresher")
        t.start()
        self._threads.append(t)
        t = threading.Thread(
            target=self._observe, args=(self._stop,),
            daemon=True, name="ptpu-observer")
        t.start()
        self._threads.append(t)
        self._server = make_server(self, self.config.host,
                                   self.config.port)
        # a short poll: the drain's HTTP stop returns within 50 ms,
        # not socketserver's default 0.5 s
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05}, daemon=True,
            name="ptpu-http")
        self._server_thread.start()
        trace.event("service.started", url=self.url)
        return self.url

    def shutdown(self, timeout: float | None = None) -> bool:
        """Graceful drain; idempotent; returns True on a clean drain.

        Order: stop ingest/refresh producers → drain the proof queue
        (finish in-flight within the budget) → farewell snapshot →
        persist the cursor → stop HTTP last (health stays observable
        while draining)."""
        if self.draining:
            return True
        self.draining = True
        timeout = self.config.drain_timeout if timeout is None else timeout
        trace.event("service.draining", timeout_s=timeout)
        self._stop.set()
        self._dirty.set()  # unblock the refresher wait
        # the watchdog goes first: joining threads stop beating, and a
        # drain must never read as a thread-stall incident
        self.watchdog.stop()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        for name in ("ptpu-tailer", "ptpu-refresher", "ptpu-observer"):
            self.beats.unregister(name)
        clean = not any(t.is_alive() for t in self._threads)
        clean = self.jobs.drain(
            timeout=max(0.1, deadline - time.monotonic())) and clean
        if self.store is not None and clean:
            # farewell snapshot so the next start replays ~nothing;
            # failure is not unclean — the WAL already covers everything
            self._take_snapshot(compact=False)
        try:
            self.tailer._persist_cursor()
        except (EigenError, OSError):
            # OSError: CheckpointManager raises raw ENOSPC/EIO — a sick
            # disk makes the drain UNCLEAN, it must not hang it (the
            # HTTP stop below is what lets wait()/the serve verb exit)
            clean = False
        if self.store is not None and clean:
            # all writers joined: release the WAL handle + state lock
            # (left open on an unclean drain — a still-live tailer
            # thread must not find its log closed under it)
            try:
                self.store.close()
            except OSError:
                clean = False  # sick disk: unclean, but NEVER hang the
                # drain thread — the HTTP stop below must still run
        self.drain_clean = clean
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server_thread.join(timeout=5.0)
        trace.event("service.stopped", clean=clean)
        return clean

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → graceful drain (main thread only — the
        ``serve`` verb calls this)."""
        import signal

        def _handle(signum, frame):
            trace.event("service.signal", signum=signum)
            # drain on a helper thread: a second signal must still be
            # deliverable, and handlers should return promptly
            threading.Thread(target=self.shutdown, daemon=True,
                             name="ptpu-drain").start()

        signal.signal(signal.SIGTERM, _handle)
        signal.signal(signal.SIGINT, _handle)

    def wait(self, poll: float = 0.2) -> None:
        """Block until shutdown completes (the serve verb's main loop)."""
        while not self._stop.is_set():
            time.sleep(poll)
        # _stop set by shutdown(); wait for the drain thread to finish
        # the queue + server teardown
        while self._server is not None and self._server_thread.is_alive():
            time.sleep(poll)
