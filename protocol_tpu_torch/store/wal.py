"""Attestation write-ahead log: length-prefixed, CRC-checked, segmented.

The daemon's opinion graph is rebuilt from this log at startup (snapshot
+ replay), so the log's one job is to never lie: a record either replays
byte-identically or is detectably absent. Format, per segment file
``wal-{i:012d}.seg``:

- 8-byte magic header ``PTPUWAL1``;
- records framed as ``u32 len | u32 crc32(body) | body`` with
  ``body = u64 block | about(20) | payload`` — the payload is the
  on-chain attestation codec (``SignedAttestationData.to_payload``,
  66 or 98 bytes), so replay round-trips through the exact decoder the
  tailer uses (``from_log``).

Durability contract:

- **append-before-apply**: the daemon appends a batch (one write, one
  optional fsync per the ``wal_fsync`` policy) before folding it into
  the graph; a failed append propagates, the cursor never advances, and
  the tailer refetches — so the log can under-persist but never skip;
- **torn tails never crash recovery**: a crash (or injected
  ``PTPU_FAULT_DISK`` torn write) mid-append leaves a frame whose
  length/CRC check fails; the replay scan stops that segment at the
  last intact frame and the writer truncates the garbage before its
  next append (``_heal``);
- **segment rotation** bounds file sizes. Since format-2 snapshots
  the log IS the attestation history — restore rebuilds the raw
  buffer from it — so snapshots do NOT prune covered segments anymore;
  :meth:`AttestationWAL.prune_below` exists only for deployments still
  on format-1 snapshots (which embed the buffer);
- **compaction** (``store compact`` offline, or the daemon at startup
  past ``wal_compact_segments``) bounds the log's growth instead:
  latest-wins duplicates fold per caller-supplied key into a fresh
  segment, then the old ones are removed — a crash in between leaves
  old + compacted, whose replay folds to the same final state, so
  compaction is crash-safe without a journal.
"""

from __future__ import annotations

import os
import struct
import time
import zlib
from collections import OrderedDict

from ..utils import trace
from ..utils.errors import EigenError

SEGMENT_MAGIC = b"PTPUWAL1"
_FRAME = struct.Struct("<II")    # body length, crc32(body)
_BLOCK = struct.Struct("<Q")     # block number prefix of the body
MAX_RECORD_BYTES = 1 << 20       # sanity bound: a frame length beyond
                                 # this is corruption, not data


def encode_record(block: int, about: bytes, payload: bytes) -> bytes:
    """One framed record: block number + about address + raw payload."""
    body = _BLOCK.pack(block) + about + payload
    return _FRAME.pack(len(body), zlib.crc32(body)) + body


def decode_body(body: bytes) -> tuple:
    """Inverse of the body part of :func:`encode_record`."""
    block = _BLOCK.unpack_from(body)[0]
    return block, body[8:28], bytes(body[28:])


def iter_frames(buf: bytes, offset: int = 0):
    """Yield ``(end_offset, body)`` per intact frame; stop at the first
    torn/corrupt frame (short header, absurd length, truncated body, or
    CRC mismatch) — everything past it in this buffer is unreadable."""
    n = len(buf)
    while True:
        if offset + _FRAME.size > n:
            return
        length, crc = _FRAME.unpack_from(buf, offset)
        if length < _BLOCK.size + 20 or length > MAX_RECORD_BYTES:
            return
        end = offset + _FRAME.size + length
        if end > n:
            return
        body = buf[offset + _FRAME.size:end]
        if zlib.crc32(body) != crc:
            return
        yield end, body
        offset = end


class AttestationWAL:
    """Single-writer segmented log; readers may scan concurrently."""

    def __init__(self, directory: str, segment_bytes: int = 4 << 20,
                 fsync: str = "always", faults=None,
                 readonly: bool = False):
        if fsync not in ("always", "never"):
            raise EigenError("config_error",
                            f"wal_fsync must be 'always' or 'never', "
                            f"got {fsync!r}")
        self.directory = directory
        self.segment_bytes = segment_bytes
        self.fsync = fsync
        self.faults = faults
        self.readonly = readonly
        self.appended = 0        # records appended by this process
        self.torn_skipped = 0    # segments whose tail/body scan stopped early
        self._file = None
        self._segment = 0
        self._pos = 0
        self._need_heal = False
        # segments rotated away with bytes never fsynced (fsync="never"
        # only): sync() must cover THEM too, not just the live tail —
        # a snapshot can claim coverage across a rotation boundary
        self._unsynced: set = set()
        if not readonly:
            os.makedirs(directory, exist_ok=True)
            self._open_tail()

    # --- segment bookkeeping ---------------------------------------------
    def _path(self, segment: int) -> str:
        return os.path.join(self.directory, f"wal-{segment:012d}.seg")

    def segments(self) -> list:
        """Existing segment indices, ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        out = []
        for name in names:
            if name.startswith("wal-") and name.endswith(".seg"):
                try:
                    out.append(int(name[4:-4]))
                except ValueError:
                    continue
        return sorted(out)

    def _start_segment(self, segment: int) -> None:
        if self._file is not None:
            if self.fsync != "always":
                # the rotated-away segment may hold page-cache-only
                # bytes; remember it until the next sync()
                self._unsynced.add(self._segment)
            self._file.close()
        self._file = open(self._path(segment), "wb")
        self._file.write(SEGMENT_MAGIC)
        self._file.flush()
        if self.fsync == "always":
            os.fsync(self._file.fileno())
        self._segment = segment
        self._pos = len(SEGMENT_MAGIC)

    def _open_tail(self) -> None:
        """Open the newest segment for append, truncating any torn tail
        left by a crash so new frames land on a valid boundary."""
        segs = self.segments()
        if not segs:
            self._start_segment(1)
            return
        seg = segs[-1]
        with open(self._path(seg), "rb") as f:
            buf = f.read()
        if buf[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
            # unreadable header: leave the file for forensics, write past it
            self.torn_skipped += 1
            self._start_segment(seg + 1)
            return
        good = len(SEGMENT_MAGIC)
        for end, _ in iter_frames(buf, good):
            good = end
        if good < len(buf):
            self.torn_skipped += 1
        self._file = open(self._path(seg), "r+b")
        self._file.truncate(good)
        self._file.seek(good)
        self._segment = seg
        self._pos = good

    def _heal(self) -> None:
        """Truncate back to the last committed frame after a failed
        append (torn write / fsync fault) so the tail stays parseable."""
        self._file.truncate(self._pos)
        self._file.seek(self._pos)
        self._need_heal = False

    # --- write ------------------------------------------------------------
    def position(self) -> tuple:
        """(segment, offset) after the last committed record — the WAL
        high-water mark a snapshot records as its replay start."""
        return self._segment, self._pos

    def sync(self) -> None:
        """Force every committed byte durable regardless of the
        ``wal_fsync`` policy — the live tail AND any segment rotated
        away since the last sync (under ``fsync="never"`` those closed
        with page-cache-only bytes). A format-2 snapshot records
        :meth:`position` as covered — i.e. the restored attestation
        buffer comes from these bytes, not the snapshot — so they must
        be on disk before the snapshot commits, or a power cut would
        leave the restored graph holding edges with no backing
        attestation. Failure propagates (the caller skips the
        snapshot); unsynced segments stay tracked for the retry."""
        if self.readonly:
            return
        for seg in sorted(self._unsynced):
            try:
                f = open(self._path(seg), "rb")
            except FileNotFoundError:
                continue  # removed by compact/prune: superseded
            with f:
                os.fsync(f.fileno())
        self._unsynced.clear()
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())

    def append(self, records) -> tuple:
        """Append ``[(block, about20, payload)]`` as one write; returns
        the position after them. Raises on (injected) disk faults — the
        records are NOT committed then, and the next append truncates
        any partial bytes before writing (lazily, so a crash right after
        the fault leaves the torn tail recovery must skip)."""
        if self.readonly:
            raise EigenError("file_io_error", "WAL opened read-only")
        if self._need_heal:
            self._heal()
        data = b"".join(encode_record(b, a, p) for b, a, p in records)
        shape = self.faults.disk_fault() if self.faults is not None else None
        f = self._file
        t0 = time.perf_counter()
        # pessimistic: marked dirty for the WHOLE write window and
        # cleared only on full commit, so a REAL write/flush/fsync error
        # (ENOSPC, EIO), not just the injected shapes, leaves the tail
        # marked for truncation — otherwise _pos and the file offset
        # diverge and every later position()/snapshot misaligns
        self._need_heal = True
        if shape == "torn":
            f.write(data[:max(_FRAME.size + 1, len(data) // 2)])
            f.flush()
            raise EigenError("injected_fault", "injected torn WAL append")
        f.write(data)
        f.flush()
        if shape == "fsync":
            raise EigenError("injected_fault", "injected WAL fsync failure")
        if self.fsync == "always":
            t_fs = time.perf_counter()
            os.fsync(f.fileno())
            trace.histogram("wal_fsync_seconds").observe(
                time.perf_counter() - t_fs)
        self._need_heal = False
        # committed appends only: a faulted append raised above, and
        # mixing its partial timing in would skew the latency tail
        trace.histogram("wal_append_seconds").observe(
            time.perf_counter() - t0)
        self._pos += len(data)
        self.appended += len(records)
        pos = (self._segment, self._pos)
        if self._pos >= self.segment_bytes:
            self._start_segment(self._segment + 1)
        return pos

    # --- read -------------------------------------------------------------
    def replay(self, start: tuple | None = None):
        """Yield ``(block, about, payload)`` for every intact record
        from ``start`` (a :meth:`position` value) or the beginning. A
        torn/corrupt frame ends that SEGMENT's scan (counted in
        ``torn_skipped``); later segments still replay — records are
        independent and the graph is latest-wins."""
        for _, record in self.replay_frames(start):
            yield record

    def replay_frames(self, start: tuple | None = None):
        """Like :meth:`replay` but yields ``((segment, end_offset),
        (block, about, payload))`` — the position AFTER each record, so
        a caller holding a snapshot's WAL high-water mark can split one
        full-log pass into "already reflected in the snapshot" (pos ≤
        mark) and "replay into the graph" (pos > mark). This is the
        restore seam since snapshots stopped persisting the raw
        attestation buffer: the buffer is rebuilt from the (compacted)
        log, the graph only from the uncovered suffix."""
        sseg, soff = start if start is not None else (0, 0)
        for seg in self.segments():
            if seg < sseg:
                continue
            try:
                with open(self._path(seg), "rb") as f:
                    buf = f.read()
            except OSError:
                continue
            if buf[:len(SEGMENT_MAGIC)] != SEGMENT_MAGIC:
                self.torn_skipped += 1
                continue
            off = len(SEGMENT_MAGIC)
            if seg == sseg:
                off = max(off, soff)
            good = off
            for end, body in iter_frames(buf, off):
                good = end
                yield (seg, end), decode_body(body)
            if good < len(buf) and not (
                    not self.readonly and seg == self._segment
                    and good >= self._pos):
                # tail garbage past the committed high-water mark of the
                # live segment is expected only after a fault; count
                # corruption, not our own in-flight heal window
                self.torn_skipped += 1

    # --- replication shipping ---------------------------------------------
    def earliest_position(self) -> tuple:
        """Position of the first record still in the log — where a
        replication consumer restarts after its cursor was invalidated
        by compaction (replay from here + content dedup folds to the
        identical state; see :meth:`compact`)."""
        segs = self.segments()
        first = segs[0] if segs else max(self._segment, 1)
        return (first, len(SEGMENT_MAGIC))

    def committed_position(self) -> tuple:
        """Reader-thread-safe :meth:`position`: the writer updates
        ``_segment`` then ``_pos`` non-atomically across a rotation, so
        a concurrent reader re-reads until two CONSECUTIVE reads agree
        — a same-order re-read of one field can't catch the (new seg,
        stale pos) tear the writer's store order actually produces.
        If the writer parks mid-transition past every retry, the torn
        pair only ever mis-clamps toward bytes that are fully written
        (a complete frame the writer is about to commit, which the
        heal path would preserve across a crash) — the CRC framing
        keeps any read safe regardless."""
        prev = (self._segment, self._pos)
        for _ in range(8):
            cur = (self._segment, self._pos)
            if cur == prev:
                return cur
            prev = cur
        return prev

    def read_chunk(self, start: tuple, max_bytes: int = 1 << 20) -> dict:
        """Committed raw frame bytes past ``start`` from ONE segment —
        the leader side of WAL segment shipping (``GET /repl/wal``).
        Returns ``{"data", "next", "eof", "gap"}``:

        - ``data``: whole frames, byte-identical to the on-disk
          framing (``u32 len | u32 crc | body``) with the segment magic
          stripped — the consumer parses with :func:`iter_frames`;
          at least one frame is returned even when it alone exceeds
          ``max_bytes``;
        - ``next``: the position after the returned bytes (advanced to
          the next segment's start when this one is consumed);
        - ``eof``: ``next`` has reached the committed tail — nothing
          more to ship until the next append;
        - ``gap``: ``start`` points into a segment that no longer
          exists (compacted away, or a fresh consumer at ``(0, 0)``) —
          ``data`` is empty and ``next`` is :meth:`earliest_position`;
          the consumer re-tails from there, deduping by content.

        Lock-free against the single appender: the committed tail is
        snapshotted FIRST, so the byte range read can never include an
        in-flight partial frame (and the CRC scan would stop at one
        regardless). Never blocks the sink thread."""
        tail = self.committed_position()
        segs = self.segments()
        sseg, soff = int(start[0]), int(start[1])
        empty = {"data": b"", "next": (sseg, soff), "eof": True,
                 "gap": False}
        if not segs:
            return empty
        if sseg not in segs:
            return {"data": b"", "next": self.earliest_position(),
                    "eof": False, "gap": True}
        try:
            with open(self._path(sseg), "rb") as f:
                magic = f.read(len(SEGMENT_MAGIC))
                later = [s for s in segs if s > sseg]
                if magic != SEGMENT_MAGIC:
                    # torn header: replay skips this segment; so does
                    # shipping
                    if later:
                        return {"data": b"",
                                "next": (later[0], len(SEGMENT_MAGIC)),
                                "eof": False, "gap": False}
                    return empty
                size = os.fstat(f.fileno()).st_size
                end = size
                if sseg == tail[0]:
                    end = min(end, tail[1])
                off = max(soff, len(SEGMENT_MAGIC))
                if off > end:
                    # a position PAST the committed bytes of its
                    # segment: the writer healed/truncated below a
                    # previously-shipped offset (torn tail discarded
                    # after a crash under fsync="never") — the
                    # position no longer names a frame boundary, and
                    # waiting at it would silently skip every later
                    # record. Re-tail from the earliest position; the
                    # consumer's content dedup folds the overlap.
                    return {"data": b"",
                            "next": self.earliest_position(),
                            "eof": False, "gap": True}
                # read ONLY the shippable range (+ one max-record
                # slack so a frame straddling the cap still parses
                # whole) — the steady-state eof poll reads 8 bytes of
                # magic and an fstat, never the whole segment
                want = min(end - off,
                           max_bytes + _FRAME.size + MAX_RECORD_BYTES)
                f.seek(off)
                buf = f.read(want)
        except OSError:  # raced a compaction removal
            return {"data": b"", "next": self.earliest_position(),
                    "eof": False, "gap": True}
        last = 0
        for fend, _ in iter_frames(buf):
            if fend > max_bytes and last > 0:
                break
            last = fend
            if last >= max_bytes:
                break
        data = bytes(buf[:last])
        nxt = (sseg, off + last)
        eof = sseg == tail[0] and off + last >= end
        if not eof and off + last >= end and later:
            # this segment is consumed; the next fetch starts clean on
            # the following one
            nxt = (later[0], len(SEGMENT_MAGIC))
        return {"data": data, "next": nxt, "eof": eof, "gap": False}

    def count_records(self, start: tuple) -> int:
        """Records between ``start`` and the committed tail — the
        shipping backlog a catch-up consumer is behind by. O(remaining
        log); the steady state (``eof`` polls) never calls it."""
        total = 0
        pos = start
        while True:
            out = self.read_chunk(pos, max_bytes=4 << 20)
            total += sum(1 for _ in iter_frames(out["data"]))
            if out["eof"] or (not out["data"] and not out["gap"]):
                return total
            if out["gap"]:
                pos = out["next"]
                if pos == start:
                    return total
                start = pos
                continue
            pos = out["next"]

    # --- maintenance ------------------------------------------------------
    def prune_below(self, segment: int) -> int:
        """Remove segments strictly below ``segment``; returns how many
        were removed. FORMAT-1 ONLY: a format-2 snapshot does not embed
        the attestation buffer — restore rebuilds it from the full log,
        so pruning covered segments would silently lose attestations on
        the next restart. The daemon no longer calls this; growth is
        bounded by latest-wins :meth:`compact` instead."""
        removed = 0
        for seg in self.segments():
            if seg >= segment:
                break
            try:
                os.remove(self._path(seg))
                removed += 1
                self._unsynced.discard(seg)
            except OSError:
                pass
        return removed

    def compact(self, key_fn) -> dict:
        """Fold latest-wins duplicates: keep, per ``key_fn(block, about,
        payload)`` key, only the newest record (order of last
        occurrence); ``key_fn`` returning None drops the record
        (undecodable/forged entries that replay would reject anyway).
        The folded records are written to a fresh segment, fsynced, and
        only then are the old segments removed — a crash in between
        replays old + folded, which folds to the same state."""
        if self.readonly:
            raise EigenError("file_io_error", "WAL opened read-only")
        records_in = 0
        dropped = 0
        folded: OrderedDict = OrderedDict()
        for block, about, payload in self.replay():
            records_in += 1
            key = key_fn(block, about, payload)
            if key is None:
                dropped += 1
                continue
            folded.pop(key, None)
            folded[key] = (block, about, payload)
        old = self.segments()
        self._start_segment((old[-1] if old else 0) + 1)
        if folded:
            data = b"".join(encode_record(b, a, p)
                            for b, a, p in folded.values())
            self._file.write(data)
            self._file.flush()
            self._pos += len(data)
        os.fsync(self._file.fileno())
        for seg in old:
            try:
                os.remove(self._path(seg))
            except OSError:
                pass
        # everything the old segments held is in the fsynced fresh
        # segment now — nothing rotated-away remains to sync
        self._unsynced -= set(old)
        return {
            "records_in": records_in,
            "records_out": len(folded),
            "dropped": dropped,
            "segments_removed": len(old),
            "segment": self._segment,
        }

    def stats(self) -> dict:
        segs = self.segments()
        total = 0
        for seg in segs:
            try:
                total += os.path.getsize(self._path(seg))
            except OSError:
                pass
        return {
            "segments": len(segs),
            "bytes": total,
            "appended": self.appended,
            "torn_skipped": self.torn_skipped,
        }

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
