"""In-memory opinion graph + signer recovery for the service.

The batch path rebuilds its opinion structures from the full CSV every
invocation; the daemon instead maintains one mutable graph:

- **interning**: addresses get APPEND-ONLY integer ids — an id is never
  reassigned, so a previous score vector indexes the first ``len(prev)``
  slots of any later snapshot (the invariant
  ``ops.converge.warm_start_scores`` builds on);
- **latest-wins edges**: the AttestationStation stores one value per
  (creator, about, key) — re-attesting overwrites (chain.py store
  semantics) — so the graph keeps a dict edge map where newer
  attestations replace older ones, value 0 meaning "retracted" (the
  filter drops non-positive weights, exactly the contract semantics);
- **edit accounting**: edits since the last cold converge feed the
  refresh staleness bound.

Signer recovery routes through the batched ingest on the card
(``client.ingest.recover_signers_batch``: the Montgomery-multiply and
modular add/subtract kernels) when a CUDA device is live and the
service runs on it — the same auto rule as ``Client.et_circuit_setup``
— and the scalar per-attestation path otherwise. Invalid signatures are counted and
skipped, never fatal: one forged attestation must not stall the tail.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from ..client.client import _device_present
from ..client.eth import address_from_public_key
from ..utils import trace
from ..utils.errors import EigenError


def att_digest(block: int, about: bytes, payload: bytes) -> bytes:
    """Identity of one signed attestation AS LOGGED — block + about +
    normalized payload. The daemon's dedup key AND the trace-context
    id derive from it; the block number MUST be part of it because
    deterministic (RFC 6979) signing makes a re-attestation of a
    previously-seen value byte-identical in payload — only its block
    distinguishes the genuine latest-wins revert from a refetch."""
    return hashlib.sha256(block.to_bytes(8, "little") + about
                          + payload).digest()


def trace_id_of(digest: bytes) -> str:
    """digest → trace id: the one place the prefix length/encoding is
    defined, so every deriver (tailer, daemon sink, smoke join) agrees."""
    return digest.hex()[:16]


def att_trace_id(block: int, about: bytes, payload: bytes) -> str:
    """The trace id stamped on every span an attestation flows through
    (tailer → WAL append → graph apply → the refresh that publishes
    it): a short prefix of the same digest the dedup key uses, so the
    id is computable from the raw log record alone."""
    return trace_id_of(att_digest(block, about, payload))


def recover_signers(attestations, batched: bool | None = None,
                    device=None):
    """[(signer_address | None)] per attestation; None = invalid.

    ``batched=None`` auto-selects the device pipeline the way the
    Client does (≥32 lanes and a CUDA device present), unless
    ``device`` names another device than the card. ``device`` is the
    batched path's torch device (None means the card)."""
    if batched is None:
        batched = (len(attestations) >= 32 and _device_present()
                   and (device is None
                        or torch.device(device).type == "cuda"))
    if batched and attestations:
        from ..client.ingest import recover_signers_batch

        _, addresses, valid = recover_signers_batch(attestations,
                                                    device=device)
        return [a if v else None for a, v in zip(addresses, valid)]
    out = []
    with trace.span("service.recover_scalar", n=len(attestations)):
        for signed in attestations:
            try:
                out.append(address_from_public_key(
                    signed.recover_public_key()))
            except (EigenError, ValueError):
                out.append(None)
    return out


class FreshnessTracker:
    """End-to-end ingest→served-scores lag, shared by the leader and
    the follower daemons (shared by both): the sink records (graph
    revision after apply, wall-clock arrival of the batch's newest
    record); :meth:`seconds` pops everything the published table's
    revision covers and reports now − the newest covered arrival —
    -1.0 until the first record is both ingested and published (the
    gauge is always present but clearly 'never')."""

    BOUND = 4096  # pending entries kept (refresh outruns ingest in
    # steady state; the bound only matters during a cold catch-up)

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list = []
        self._anchor: float | None = None

    def record(self, revision: int, arrived_at: float) -> None:
        with self._lock:
            self._pending.append((revision, arrived_at))
            if len(self._pending) > self.BOUND:
                del self._pending[0]

    def seconds(self, table_revision: int, now: float) -> float:
        with self._lock:
            while (self._pending
                   and self._pending[0][0] <= table_revision):
                self._anchor = self._pending.pop(0)[1]
            if self._anchor is None:
                return -1.0
            return now - self._anchor


class OpinionGraph:
    """Mutable trust graph; snapshots are cheap numpy edge arrays."""

    # edge-change log bound: past this without a drain the log is
    # declared lost (the consumer re-anchors from a full snapshot
    # instead of replaying an unbounded backlog)
    DELTA_LOG_MAX = 1 << 20

    def __init__(self):
        self._lock = threading.RLock()
        self._ids: dict = {}       # address bytes -> id
        self._addrs: list = []     # id -> address bytes
        self._edges: dict = {}     # (src_id, dst_id) -> value
        self.revision = 0          # bumps on every effective change
        self.edits_since_cold = 0
        self.invalid = 0           # rejected attestations (bad sig/self)
        # edge-change log for the incremental delta engine
        # (``incremental``): every effective edge change is
        # recorded as (src, dst, old_value, new_value) — old None for a
        # first-ever edge — and drained atomically with a snapshot so
        # the consumer's view can never tear against the edge arrays
        self._delta_log: list = []
        self._delta_lost = False

    def _intern(self, addr: bytes) -> int:
        i = self._ids.get(addr)
        if i is None:
            i = len(self._addrs)
            self._ids[addr] = i
            self._addrs.append(addr)
        return i

    # --- ingest -----------------------------------------------------------
    def apply(self, attestations, signer_addrs) -> int:
        """Fold a decoded batch in; returns the number of effective edge
        changes. Self-attestations and invalid signers are counted in
        ``invalid`` and dropped (the filter would null them anyway —
        rejecting here keeps them out of the peer set too)."""
        changed = 0
        with self._lock:
            for signed, signer in zip(attestations, signer_addrs):
                about = signed.attestation.about
                if signer is None or signer == about:
                    self.invalid += 1
                    continue
                i = self._intern(signer)
                j = self._intern(about)
                value = float(signed.attestation.value)
                old = self._edges.get((i, j))
                if old != value:
                    self._edges[(i, j)] = value
                    changed += 1
                    if len(self._delta_log) < self.DELTA_LOG_MAX:
                        self._delta_log.append((i, j, old, value))
                    else:
                        self._delta_lost = True
            if changed:
                self.revision += 1
                self.edits_since_cold += changed
            trace.metric("service.peers", len(self._addrs))
            trace.metric("service.edges", len(self._edges))
            trace.metric("service.revision", self.revision)
            trace.metric("service.invalid_attestations", self.invalid)
        return changed

    def mark_cold(self, edits: int | None = None) -> None:
        """A cold refresh covered ``edits`` of the edits since the last
        one (the count its cut read; None: all of them). The refresher
        passes its count: the reference's reset to 0 forgets the edits
        applied while the refresh ran, so the next refresh warm-starts
        although ``cold_edit_fraction`` asks for a cold one."""
        with self._lock:
            self.edits_since_cold = (
                0 if edits is None
                else max(0, self.edits_since_cold - int(edits)))

    # --- durability (``store`` snapshots) ------------------------
    def restore_state(self, addrs, edges, revision: int,
                      edits_since_cold: int, invalid: int = 0) -> None:
        """Adopt a snapshot's cut wholesale (restart path). Interning
        order is reproduced exactly, so ids — and therefore any restored
        score vector — keep their meaning."""
        with self._lock:
            self._addrs = list(addrs)
            self._ids = {a: i for i, a in enumerate(self._addrs)}
            self._edges = dict(edges)
            self.revision = int(revision)
            self.edits_since_cold = int(edits_since_cold)
            self.invalid = int(invalid)
            # the restored cut IS the new baseline: any delta consumer
            # re-anchors from it, the old log is meaningless
            self._delta_log = []
            self._delta_lost = False

    def delta_cut(self):
        """``(n, revision, edits_since_cold, deltas, deltas_lost)``
        under one lock hold — the delta engine's O(dirty) twin of
        :meth:`snapshot`: the edge-change log since the last drain plus
        the scalars a delta-served refresh needs, WITHOUT materializing
        the O(E) edge arrays. This is the point of the engine's fast
        path — a churn window must not walk the whole edge dict while
        holding the lock the ingest sink needs."""
        with self._lock:
            deltas, lost = self._delta_log, self._delta_lost
            self._delta_log, self._delta_lost = [], False
            return (len(self._addrs), self.revision,
                    self.edits_since_cold, deltas, lost)

    # --- snapshots --------------------------------------------------------
    @property
    def n(self) -> int:
        with self._lock:
            return len(self._addrs)

    @property
    def n_edges(self) -> int:
        with self._lock:
            return len(self._edges)

    def address_of(self, peer_id: int) -> bytes:
        with self._lock:
            return self._addrs[peer_id]

    def id_of(self, addr: bytes):
        with self._lock:
            return self._ids.get(addr)

    def addresses(self) -> tuple:
        with self._lock:
            return tuple(self._addrs)

    def snapshot(self, drain_deltas: bool = False):
        """(n, src, dst, val, revision, edits_since_cold) under one lock
        hold — a consistent cut for the refresher. Zero-valued edges are
        included; ``graph.filter_edges`` drops them (contract
        semantics: value 0 = retracted).

        ``drain_deltas=True`` (the refresher, single consumer) appends
        ``(deltas, deltas_lost)`` to the tuple: the edge-change log
        since the previous drain, taken in the SAME lock hold so the
        delta engine's incremental view and the full edge arrays
        describe the identical cut. ``deltas_lost`` means the log
        overflowed and the consumer must re-anchor from the arrays."""
        with self._lock:
            n = len(self._addrs)
            m = len(self._edges)
            src = np.empty(m, dtype=np.int64)
            dst = np.empty(m, dtype=np.int64)
            val = np.empty(m, dtype=np.float64)
            for e, ((i, j), v) in enumerate(self._edges.items()):
                src[e], dst[e], val[e] = i, j, v
            out = (n, src, dst, val, self.revision, self.edits_since_cold)
            if drain_deltas:
                deltas, lost = self._delta_log, self._delta_lost
                self._delta_log, self._delta_lost = [], False
                out = out + (deltas, lost)
            return out
