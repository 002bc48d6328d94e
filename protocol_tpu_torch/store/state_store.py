"""StateStore: the one handle the daemon (and the ``store`` CLI verb)
holds on a state directory. Layout::

    <state-dir>/
      wal/          attestation write-ahead log segments
      snapshots/    revision-stepped graph snapshots
      proofs/       persisted proof artifacts (overridable — the CLI
                    points it at the EigenFile assets layout)
      operators/    compiled routed-operator cache (refresh at scale)
      cursor/       block-cursor checkpoints (owned by the tailer's
                    CheckpointManager, created by the daemon wiring)

The store itself is mechanism only — what goes INTO snapshots and when,
and what replay means, is the daemon's policy (``service/daemon.py``).
"""

from __future__ import annotations

import os

from ..utils.errors import EigenError
from .artifacts import ProofArtifactStore
from .snapshot import SnapshotStore
from .wal import AttestationWAL


def acquire_state_lock(root: str):
    """Exclusive advisory lock on ``<root>/LOCK`` — one WAL writer at a
    time (the daemon, or an offline ``store compact``). Returns the open
    lock file (hold it for the writer's lifetime); raises if another
    process holds it. No-op (returns None) where flock is unavailable."""
    try:
        import fcntl
    except ImportError:  # non-POSIX: advisory locking degrades to docs
        return None
    os.makedirs(root, exist_ok=True)
    f = open(os.path.join(root, "LOCK"), "w")
    try:
        fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        f.close()
        raise EigenError(
            "config_error",
            f"state dir {root} is locked by another process (a running "
            "serve daemon?) — stop it first")
    return f


class StateStore:
    """WAL + snapshots + proof artifacts under one root."""

    def __init__(self, root: str, segment_bytes: int = 4 << 20,
                 fsync: str = "always", snapshot_keep: int = 2,
                 faults=None, proofs_dir: str | None = None):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock_file = acquire_state_lock(root)
        self.wal = AttestationWAL(
            os.path.join(root, "wal"), segment_bytes=segment_bytes,
            fsync=fsync, faults=faults)
        self.snapshots = SnapshotStore(
            os.path.join(root, "snapshots"), keep=snapshot_keep,
            faults=faults)
        self.artifacts = ProofArtifactStore(
            proofs_dir or os.path.join(root, "proofs"), faults=faults)
        self.operators_dir = os.path.join(root, "operators")
        self.replayed_records = 0   # set by the daemon after restore
        self.snapshot_failures = 0

    def metrics(self) -> dict:
        """Store gauges for /metrics (``ptpu_store_*`` after rendering)."""
        wal = self.wal.stats()
        return {
            "store.wal_segments": float(wal["segments"]),
            "store.wal_bytes": float(wal["bytes"]),
            "store.wal_records_appended": float(wal["appended"]),
            "store.wal_torn_skipped": float(wal["torn_skipped"]),
            "store.snapshot_age_seconds": self.snapshots.age_seconds(),
            "store.snapshots": float(self.snapshots.count()),
            "store.snapshot_failures": float(self.snapshot_failures),
            "store.replayed_records": float(self.replayed_records),
            "store.proof_artifacts": float(self.artifacts.count()),
            "store.proof_persist_failures": float(
                self.artifacts.persist_failures),
        }

    def close(self) -> None:
        self.wal.close()
        if self._lock_file is not None:
            self._lock_file.close()  # closing drops the flock
            self._lock_file = None
