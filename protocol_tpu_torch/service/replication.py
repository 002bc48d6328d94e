"""WAL segment shipping: the leader/follower replication fabric.

The store formats ARE the replication protocol — WAL segments are
CRC-framed and replay-deterministic, snapshots atomic — so replication
is a thin transport over them, not a new format:

- :class:`ReplicationSource` (leader): serves committed WAL frames
  past a follower's position (``GET /repl/wal?from=seg:off`` — the
  bytes are the on-disk framing verbatim, parsed by the same
  ``iter_frames`` replay uses) and the newest snapshot for bootstrap
  (``GET /repl/snapshot``). Reads never block the sink thread (the
  WAL's single appender): the committed tail is snapshotted first and
  files are read lock-free. Tracks each follower's shipped position +
  last-seen time, which gives the leader two things: the ``repl``
  status section, and the **ship floor** — WAL compaction (which
  rewrites every segment, invalidating all shipped positions) defers
  while an active follower is still catching up, the replication twin
  of the PR-6 cursor floor. A follower whose position was compacted
  away anyway (it was disconnected past the TTL) gets a ``gap``
  response pointing at the earliest position and re-tails the folded
  log from there — replay + content dedup fold to the identical state,
  the same argument that makes compaction crash-safe.

- :class:`WalShipClient` (follower): the HTTP client side — fetch a
  chunk past the cursor, fetch the bootstrap snapshot, fetch the
  signed score bundle with ``If-None-Match``. Network errors raise
  ``EigenError("rpc_error")`` so the follower's poll loop applies the
  tailer's exponential-backoff discipline unchanged.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from ..store.wal import iter_frames
from ..utils import trace
from ..utils.errors import EigenError


def parse_position(text: str) -> tuple:
    """``"seg:off"`` → ``(seg, off)`` (the URL/header encoding of a
    WAL position)."""
    try:
        seg, off = text.split(":")
        return int(seg), int(off)
    except (ValueError, AttributeError) as e:
        raise EigenError("validation_error",
                         f"bad WAL position {text!r} (want seg:off)") \
            from e


def format_position(pos: tuple) -> str:
    return f"{int(pos[0])}:{int(pos[1])}"


class ReplicationSource:
    """Leader-side shipping state over a live :class:`StateStore`."""

    # tracked-follower bound: /repl/wal is on the same operator-trusted
    # loopback surface as POST /proofs, but hygiene is cheap — a
    # client cycling follower ids must not grow the dict (and with it
    # the status page + the compaction floor's scan) without bound
    MAX_FOLLOWERS = 64
    # exact-backlog scan bound: past this many remaining bytes the
    # record backlog is an ESTIMATE from byte distance (documented on
    # the gauge), so one catch-up poll never re-walks a huge log
    BACKLOG_SCAN_BYTES = 4 << 20

    def __init__(self, store, follower_ttl: float = 120.0):
        self.store = store
        self.follower_ttl = follower_ttl
        self._lock = threading.Lock()
        self._followers: dict = {}  # id -> {pos, seen, eof, records}
        self.chunks_shipped = 0
        self.records_shipped = 0
        self.bytes_shipped = 0
        self.gaps_served = 0

    def _remaining_bytes(self, pos: tuple) -> int:
        """Committed bytes between ``pos`` and the tail, from segment
        sizes — O(#segments), no frame parsing."""
        tail = self.store.wal.committed_position()
        total = 0
        for seg in self.store.wal.segments():
            if seg < pos[0]:
                continue
            try:
                size = os.path.getsize(self.store.wal._path(seg))
            except OSError:
                continue
            if seg == tail[0]:
                size = min(size, tail[1])
            if seg == pos[0]:
                size -= min(size, pos[1])
            total += max(size, 0)
        return total

    def _backlog(self, pos: tuple, chunk_bytes: int,
                 chunk_records: int) -> int:
        """Records behind ``pos``: exact (frame scan) while the
        remainder is small, a byte-distance estimate during deep
        catch-up — a follower bootstrapping an N-byte log must not
        cost the leader O(N²) re-scans (it is already paying O(N) to
        ship the bytes themselves)."""
        remaining = self._remaining_bytes(pos)
        if remaining <= 0:
            return 0
        if remaining <= self.BACKLOG_SCAN_BYTES:
            return self.store.wal.count_records(pos)
        avg = (chunk_bytes / chunk_records
               if chunk_records else 96.0)
        return max(1, int(remaining / max(avg, 16.0)))

    # --- wal shipping -----------------------------------------------------
    def wal_chunk(self, start: tuple, max_bytes: int = 1 << 20,
                  follower: str | None = None) -> dict:
        """One shipping read (the ``/repl/wal`` body): the WAL chunk
        plus the record count in it and — only when the consumer is
        still behind — the remaining backlog (the steady-state ``eof``
        poll pays segment stats, never a scan)."""
        out = self.store.wal.read_chunk(start, max_bytes=max_bytes)
        records = sum(1 for _ in iter_frames(out["data"]))
        backlog = 0 if out["eof"] else \
            self._backlog(out["next"], len(out["data"]), records)
        now = time.monotonic()
        with self._lock:
            self.chunks_shipped += 1
            self.records_shipped += records
            self.bytes_shipped += len(out["data"])
            if out["gap"]:
                self.gaps_served += 1
            if follower:
                self._followers[follower] = {
                    "pos": out["next"], "seen": now,
                    "eof": out["eof"], "records": records
                    + self._followers.get(follower, {}).get("records", 0),
                }
                if len(self._followers) > self.MAX_FOLLOWERS \
                        or any(now - f["seen"] > self.follower_ttl
                               for f in self._followers.values()):
                    # prune expired rows; past the cap, oldest-seen go
                    # first (an id past the TTL re-registers cleanly
                    # on its next poll)
                    rows = sorted(self._followers.items(),
                                  key=lambda kv: kv[1]["seen"],
                                  reverse=True)
                    self._followers = {
                        fid: f for fid, f in rows[:self.MAX_FOLLOWERS]
                        if now - f["seen"] <= self.follower_ttl}
        trace.counter("repl_chunks").inc(1.0)
        if records:
            trace.counter("repl_records_shipped").inc(float(records))
        out["records"] = records
        out["backlog"] = backlog
        return out

    # --- bootstrap snapshot -----------------------------------------------
    def snapshot_blob(self) -> tuple | None:
        """``(step, meta, npz_bytes)`` of the newest complete snapshot,
        read scrape-safely (no tmp sweep — this runs on HTTP threads
        against the live writer); None when no snapshot exists yet (a
        fresh follower then tails the WAL from the beginning)."""
        from ..store.snapshot import (
            list_steps_readonly,
            read_meta_readonly,
        )

        directory = self.store.snapshots.directory
        for step in reversed(list_steps_readonly(directory)):
            meta = read_meta_readonly(directory, step)
            if meta is None:
                continue
            try:
                with open(os.path.join(
                        directory, f"step-{step:012d}.npz"), "rb") as f:
                    return step, meta, f.read()
            except OSError:
                continue  # pruned between listing and read
        return None

    # --- ship floor -------------------------------------------------------
    def catching_up(self) -> bool:
        """True while an ACTIVE follower (seen within the TTL) has not
        reached the committed tail — the WAL-compaction ship floor:
        folding now would invalidate a position mid-catch-up and force
        a full re-ship. Followers past the TTL don't hold the floor
        (a dead replica must not pin the log forever); they re-tail
        from the earliest position when they come back."""
        now = time.monotonic()
        with self._lock:
            return any(now - f["seen"] <= self.follower_ttl
                       and not f["eof"]
                       for f in self._followers.values())

    def status(self) -> dict:
        now = time.monotonic()
        with self._lock:
            followers = [
                {"follower": fid,
                 "position": format_position(f["pos"]),
                 "eof": f["eof"],
                 "records_shipped": f["records"],
                 "seen_seconds_ago": round(now - f["seen"], 1),
                 "active": now - f["seen"] <= self.follower_ttl}
                for fid, f in sorted(self._followers.items())]
            return {
                "followers": followers,
                "chunks_shipped": self.chunks_shipped,
                "records_shipped": self.records_shipped,
                "bytes_shipped": self.bytes_shipped,
                "gaps_served": self.gaps_served,
            }


class WalShipClient:
    """Follower-side HTTP client for the leader's replication routes."""

    def __init__(self, base_url: str, follower_id: str,
                 max_bytes: int = 1 << 20, timeout: float = 15.0):
        self.base_url = base_url.rstrip("/")
        self.follower_id = follower_id
        self.max_bytes = max_bytes
        self.timeout = timeout

    def _open(self, path: str, headers: dict | None = None):
        req = urllib.request.Request(self.base_url + path,
                                     headers=headers or {})
        return urllib.request.urlopen(req, timeout=self.timeout)

    def fetch_wal(self, pos: tuple) -> dict:
        """One shipped chunk past ``pos``: ``{"data", "next", "eof",
        "gap", "records", "backlog"}`` (the leader's
        :meth:`ReplicationSource.wal_chunk` over the wire)."""
        path = (f"/repl/wal?from={format_position(pos)}"
                f"&max={self.max_bytes}&follower={self.follower_id}")
        try:
            with self._open(path) as resp:
                data = resp.read()
                h = resp.headers
                return {
                    "data": data,
                    "next": parse_position(h["X-Ptpu-Wal-Next"]),
                    "eof": h.get("X-Ptpu-Repl-Eof") == "1",
                    "gap": h.get("X-Ptpu-Repl-Gap") == "1",
                    "records": int(h.get("X-Ptpu-Repl-Records", "0")),
                    "backlog": int(h.get("X-Ptpu-Repl-Backlog", "0")),
                }
        except (urllib.error.URLError, OSError, ValueError, KeyError,
                EigenError) as e:
            raise EigenError("rpc_error",
                             f"wal fetch from {self.base_url}: {e}") \
                from e

    def fetch_snapshot(self) -> tuple | None:
        """``(step, arrays, meta)`` of the leader's newest snapshot for
        bootstrap; None when the leader has none yet."""
        try:
            with self._open("/repl/snapshot") as resp:
                blob = resp.read()
                meta = json.loads(resp.headers["X-Ptpu-Snapshot-Meta"])
                step = int(resp.headers["X-Ptpu-Snapshot-Step"])
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise EigenError("rpc_error",
                             f"snapshot fetch: HTTP {e.code}") from e
        except (urllib.error.URLError, OSError, ValueError,
                KeyError) as e:
            raise EigenError("rpc_error",
                             f"snapshot fetch from {self.base_url}: "
                             f"{e}") from e
        with np.load(io.BytesIO(blob)) as z:
            arrays = {k: z[k] for k in z.files}
        return step, arrays, meta

    def fetch_bundle(self, etag: str | None = None) -> tuple | None:
        """``(body_bytes, etag)`` of the leader's signed score bundle,
        or None when unchanged (``If-None-Match`` 304) or not yet
        published (404)."""
        headers = {"If-None-Match": etag} if etag else {}
        try:
            with self._open("/bundle", headers) as resp:
                return resp.read(), resp.headers.get("ETag", "")
        except urllib.error.HTTPError as e:
            if e.code in (304, 404):
                return None
            raise EigenError("rpc_error",
                             f"bundle fetch: HTTP {e.code}") from e
        except (urllib.error.URLError, OSError) as e:
            raise EigenError("rpc_error",
                             f"bundle fetch from {self.base_url}: "
                             f"{e}") from e
