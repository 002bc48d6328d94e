"""Durable state store for the trust-scores service.

The daemon is long-running; this package makes it *restartable*:
a SIGKILL'd daemon comes back serving identical scores without
re-fetching a single pre-cursor block, because everything that matters
was already on disk —

- :class:`AttestationWAL` (``wal.py``) — length-prefixed, CRC-checked,
  segment-rotated log of raw attestations, appended before graph apply;
  torn tails are detected and skipped, compaction folds latest-wins
  duplicates crash-safely;
- :class:`SnapshotStore` (``snapshot.py``) — atomic graph snapshots
  (interned ids, edges, the published score vector, the attestation
  buffer, the covered WAL position) on the ``utils/checkpoint.py``
  tmp+rename discipline, with newest→oldest fallback on corruption;
- :class:`ProofArtifactStore` (``artifacts.py``) — finished proof jobs
  persisted one directory per job (EigenFile-style stable names),
  backing ``GET /proofs/<id>/proof.bin`` and restart rehydration;
- :class:`StateStore` (``state_store.py``) — the facade bundling the
  three under one ``--state-dir`` root.

Restart = snapshot restore + WAL replay from the snapshot's position +
cursor resume; the refresher then warm-starts from the restored score
vector (PAPERS.md, arXiv 2606.11956 — a handful of iterations, not a
cold sweep). Disk failures are injectable via ``PTPU_FAULT_DISK``
(``service/faults.py``) as torn writes and fsync faults.
"""

from .artifacts import ProofArtifactStore
from .snapshot import SnapshotStore, decode_service_state, encode_service_state
from .state_store import StateStore
from .wal import AttestationWAL, decode_body, encode_record, iter_frames

__all__ = [
    "AttestationWAL",
    "ProofArtifactStore",
    "SnapshotStore",
    "StateStore",
    "decode_body",
    "decode_service_state",
    "encode_record",
    "encode_service_state",
    "iter_frames",
]
