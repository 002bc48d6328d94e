"""Atomic graph snapshots for the service: the restart fast path.

A snapshot is one ``utils/checkpoint.py`` checkpoint (numpy payload +
JSON sidecar, tmp+rename both, payload-before-sidecar) stepped by graph
revision, holding everything a restarted daemon needs to serve
identical scores without re-fetching a single pre-cursor block:

- the interned id space (id → 20-byte address, append-only, so a
  restored score vector keeps indexing correctly),
- the latest-wins edge map and its edit accounting,
- the last published score vector + its revision (the warm-start seam:
  the restored refresher resumes from the old fixed point instead of a
  forced cold resync — the partially-observed-products bound in
  PAPERS.md is exactly about this restart),
- the raw attestation buffer (WAL record codec, so the proof provers
  see the same signed attestations after a restart),
- the WAL position the snapshot covers (replay starts there).

Atomicity is inherited from ``CheckpointManager``: a half-written
snapshot is a ``*.tmp.*`` file or a payload without its sidecar, both
invisible to ``steps()``. On top of that, :meth:`SnapshotStore.
load_latest` walks newest→oldest skipping unreadable checkpoints — a
corrupt latest (bit rot, injected fault) degrades to the previous
snapshot plus a longer WAL replay, never a crash.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..utils import trace
from ..utils.checkpoint import CheckpointManager
from ..utils.errors import EigenError
from .wal import encode_record, iter_frames, decode_body


class SnapshotStore:
    """Revision-stepped snapshots with fault injection + resilient load."""

    def __init__(self, directory: str, keep: int = 2, faults=None):
        self._mgr = CheckpointManager(directory, keep=keep)
        self.directory = directory
        self.faults = faults
        self.last_saved_at: float | None = None
        self.unreadable_skipped = 0
        # cached for count(): CheckpointManager.steps() sweeps *.tmp.*
        # litter, which is only safe from the WRITER thread — /metrics
        # and /healthz must never race an in-progress save's tmp file
        self._count = len(self._mgr.steps())

    def save(self, step: int, arrays: dict, meta: dict | None = None) -> str:
        shape = self.faults.disk_fault() if self.faults is not None else None
        if shape == "torn":
            # persist the half-written payload a crash would leave: a
            # *.tmp.* file, which steps()/load_latest must ignore+sweep
            tmp = os.path.join(self.directory,
                               f"step-{step:012d}.tmp.npz")
            with open(tmp, "wb") as f:
                f.write(b"PK\x03\x04torn-snapshot")
            raise EigenError("injected_fault",
                             "injected torn snapshot write")
        if shape == "fsync":
            raise EigenError("injected_fault",
                             "injected snapshot fsync failure")
        t0 = time.perf_counter()
        path = self._mgr.save(step, arrays, meta)
        trace.histogram("snapshot_save_seconds").observe(
            time.perf_counter() - t0)
        self.last_saved_at = time.time()
        self._count = len(self._mgr.steps())  # writer thread: safe
        return path

    def steps(self) -> list:
        """Writer/offline callers only (restore, CLI inspect) — see
        the ``_count`` note in ``__init__``."""
        return self._mgr.steps()

    def count(self) -> int:
        """Scrape-safe snapshot count (no directory scan, no sweep)."""
        return self._count

    def load_latest(self) -> tuple | None:
        """(step, arrays, meta) of the newest READABLE snapshot; None if
        none exists. Unreadable ones (corrupt payload/sidecar) are
        skipped, not fatal — the WAL replays the difference."""
        for step in reversed(self._mgr.steps()):
            try:
                return self._mgr.restore(step)
            except Exception:  # noqa: BLE001 - any corruption shape
                # (bad zip, truncated json, missing key) falls back
                self.unreadable_skipped += 1
        return None

    def age_seconds(self) -> float:
        """Seconds since the last save this process made (restore does
        not count — a restarted daemon should snapshot soon); -1 until
        then, so the gauge is always present but clearly 'never'."""
        if self.last_saved_at is None:
            return -1.0
        return time.time() - self.last_saved_at


def list_steps_readonly(directory: str) -> list:
    """Completed snapshot steps WITHOUT the tmp-litter sweep — safe to
    run against a LIVE daemon's snapshot dir (``store inspect``), where
    ``CheckpointManager.steps()``'s sweep could unlink an in-progress
    save's tmp file. Same completion rule: payload + sidecar present."""
    import re as _re

    try:
        names = set(os.listdir(directory))
    except OSError:
        return []
    out = []
    for name in names:
        m = _re.fullmatch(r"step-(\d{12})\.json", name)
        if m and f"step-{m.group(1)}.npz" in names:
            out.append(int(m.group(1)))
    return sorted(out)


def read_meta_readonly(directory: str, step: int) -> dict | None:
    """One snapshot's JSON sidecar, no payload load, no mutation."""
    import json

    try:
        with open(os.path.join(directory,
                               f"step-{step:012d}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# --- service-state codec ---------------------------------------------------


def encode_service_state(addrs, src, dst, val, revision, edits_since_cold,
                         invalid, table, wal_pos,
                         n_attestations: int = 0) -> tuple:
    """(arrays, meta) for one consistent service cut. ``src``/``dst``/
    ``val`` are the edge arrays ``OpinionGraph.snapshot()`` already
    packs (no second dict walk here); ``table`` is the published
    ScoreTable (its revision may trail ``revision``; the restored
    refresher warm-refreshes the gap); ``wal_pos`` the WAL high-water
    mark the snapshot covers.

    Format 2 (O(graph), not O(history)): the raw attestation
    buffer is NOT serialized — the snapshot persists only the WAL
    coverage position, and restore rebuilds the buffer by replaying the
    (compacted) WAL from the beginning while applying only the
    uncovered suffix to the graph. Encode cost is O(graph), flat in
    attestation history; the WAL's own growth is bounded by its
    latest-wins compaction. Format-1 snapshots (with ``att_blob``)
    stay restorable."""
    t0 = time.perf_counter()
    n = len(addrs)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    val = np.asarray(val, dtype=np.float64)
    arrays = {
        "addrs": (np.frombuffer(b"".join(addrs), dtype=np.uint8)
                  .reshape(n, 20) if n else np.zeros((0, 20), np.uint8)),
        "src": src,
        "dst": dst,
        "val": val,
        "scores": np.asarray(table.scores, dtype=np.float64),
    }
    meta = {
        "kind": "service-state",
        "fmt": 2,
        "revision": int(revision),
        "edits_since_cold": int(edits_since_cold),
        "invalid": int(invalid),
        "score_revision": int(table.revision),
        "iterations": int(table.iterations),
        "delta": float(table.delta),
        "cold": bool(table.cold),
        "computed_at": float(table.computed_at),
        "n_attestations": int(n_attestations),
        "wal_segment": int(wal_pos[0]),
        "wal_offset": int(wal_pos[1]),
    }
    trace.histogram("snapshot_encode_seconds").observe(
        time.perf_counter() - t0)
    return arrays, meta


def decode_service_state(arrays, meta) -> dict:
    """Inverse of :func:`encode_service_state`; for format-1 snapshots
    the embedded attestations come back as raw ``(block, about,
    payload)`` records; format 2 returns none (``buffer_in_snapshot``
    False) and the daemon rebuilds the buffer from the WAL."""
    addr_rows = np.asarray(arrays["addrs"], dtype=np.uint8)
    addrs = [bytes(row) for row in addr_rows]
    src = np.asarray(arrays["src"], dtype=np.int64)
    dst = np.asarray(arrays["dst"], dtype=np.int64)
    val = np.asarray(arrays["val"], dtype=np.float64)
    edges = {(int(src[e]), int(dst[e])): float(val[e])
             for e in range(len(src))}
    att_records = []
    buffer_in_snapshot = "att_blob" in arrays
    if buffer_in_snapshot:  # format 1: O(history) blob, still readable
        blob = np.asarray(arrays["att_blob"], dtype=np.uint8).tobytes()
        att_records = [decode_body(body) for _, body in iter_frames(blob)]
    return {
        "buffer_in_snapshot": buffer_in_snapshot,
        "addrs": addrs,
        "edges": edges,
        "revision": int(meta["revision"]),
        "edits_since_cold": int(meta["edits_since_cold"]),
        "invalid": int(meta.get("invalid", 0)),
        "score_revision": int(meta["score_revision"]),
        "iterations": int(meta.get("iterations", 0)),
        "delta": float(meta.get("delta", 0.0)),
        "cold": bool(meta.get("cold", True)),
        "computed_at": float(meta.get("computed_at", 0.0)),
        "scores": np.asarray(arrays["scores"], dtype=np.float64),
        "att_records": att_records,
        "wal_pos": (int(meta["wal_segment"]), int(meta["wal_offset"])),
    }
