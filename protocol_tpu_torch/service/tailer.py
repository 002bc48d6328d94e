"""Chain tailer: follow the AttestationStation with a durable cursor.

The batch flow (``Client.get_attestations``) refetches the full log
history every invocation; a daemon must instead *tail* — fetch only
blocks past a cursor, survive RPC faults without losing place, and
resume after a restart from persisted state. Semantics:

- the cursor is the highest block number whose attestations have been
  fully handed to the sink; polls fetch ``get_logs(cursor + 1)``;
- the cursor is persisted through ``utils.checkpoint.CheckpointManager``
  (atomic tmp+rename, bounded retention) and restored on start — the
  same crash-safety contract the long convergence runs rely on;
- RPC faults (real or injected, ``faults.py``) retry with exponential
  backoff capped at ``backoff_max``; the cursor NEVER advances on a
  failed poll, so a retried fetch re-reads the same block range —
  get_logs is idempotent and the opinion graph's latest-wins edges make
  replays harmless;
- only this client's domain reaches the sink (topic key filter, the
  contract ``Client.get_attestations`` enforces — lib.rs:633-645);
  undecodable payloads on the right key are counted and skipped, never
  fatal (an attacker can emit arbitrary bytes at our key).
"""

from __future__ import annotations

import time

import numpy as np

from ..client.attestation import DOMAIN_PREFIX, SignedAttestationData
from ..utils import trace
from ..utils.errors import EigenError
from .faults import FaultInjector
from .state import att_trace_id


class FileBackedLocalChain:
    """Read-only AttestationStation view over the CLI's persisted local
    chain (``chain.json``): ``get_logs`` re-reads the file when its
    mtime changes, so a ``serve`` process tails ``attest`` invocations
    made by OTHER processes against the ``node_url = "memory"`` chain.
    Missing file = empty chain (nothing attested yet)."""

    def __init__(self, path):
        self.path = path
        self._mtime = None
        self._chain = None

    def get_logs(self, from_block: int = 0) -> list:
        import json
        import os

        from ..client.chain import LocalChain

        try:
            mtime = os.stat(self.path).st_mtime_ns
        except OSError:
            self._chain, self._mtime = None, None
            return []
        if self._chain is None or mtime != self._mtime:
            try:
                with open(self.path) as f:
                    self._chain = LocalChain.from_json(json.load(f))
                self._mtime = mtime
            except (OSError, ValueError, KeyError) as e:
                raise EigenError("file_io_error",
                                 f"unreadable local chain {self.path}: "
                                 f"{e}") from e
        return self._chain.get_logs(from_block)


class ChainTailer:
    """Pull-based tailer; ``poll_once`` is the unit the daemon loops."""

    def __init__(self, chain, domain: bytes, sink, checkpoints,
                 faults: FaultInjector | None = None,
                 backoff_base: float = 0.5, backoff_max: float = 30.0):
        """``chain``: any AttestationStation (RpcChain, LocalChain, …);
        ``sink(attestations, block, blocks)``: called with each decoded
        batch, the top block of the poll, and the per-attestation block
        numbers (the WAL records them) — must complete (or raise)
        before the cursor advances; ``checkpoints``: a
        CheckpointManager for cursor durability."""
        if len(domain) != 20:
            raise EigenError("config_error", "domain must be 20 bytes")
        self.chain = chain
        self.domain = domain
        self.sink = sink
        self.checkpoints = checkpoints
        self.faults = faults or FaultInjector({"rpc": 0.0, "device": 0.0})
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.cursor = self._restore_cursor()
        self.persisted_cursor = self.cursor  # last value known on disk
        self.consecutive_failures = 0
        self.batches = 0
        self.attestations = 0
        self.skipped = 0
        self.retries = 0

    # --- cursor durability ------------------------------------------------
    def _restore_cursor(self) -> int:
        step = self.checkpoints.latest()
        if step is None:
            return 0
        _, arrays, _ = self.checkpoints.restore(step)
        return int(arrays["cursor"][0])

    def _persist_cursor(self) -> None:
        self.checkpoints.save(
            self.cursor,
            {"cursor": np.asarray([self.cursor], dtype=np.int64)},
            meta={"kind": "block-cursor"})
        # only after a SUCCESSFUL save: a failed persist leaves the
        # in-memory cursor ahead of disk, and consumers that need the
        # refetch floor (WAL compaction) must see the on-disk value
        self.persisted_cursor = self.cursor

    # --- one poll ---------------------------------------------------------
    def poll_once(self) -> int:
        """Fetch logs past the cursor, decode, hand to the sink, advance
        + persist the cursor. Returns the number of attestations
        delivered. Raises on RPC failure (the run loop owns backoff)."""
        with trace.span("service.poll", cursor=self.cursor):
            logs = self.faults.call("rpc", self.chain.get_logs,
                                    self.cursor + 1)
        if not logs:
            trace.gauge("tailer_blocks_behind").set(0.0)
            return 0
        expected_key = DOMAIN_PREFIX + self.domain
        batch = []
        blocks = []
        top = self.cursor
        for log in logs:
            top = max(top, log.block_number)
            if log.key != expected_key:
                continue
            try:
                batch.append(SignedAttestationData.from_log(
                    log.about, log.key, log.val))
                blocks.append(log.block_number)
            except EigenError:
                self.skipped += 1
        # blocks this poll must still fold in before the cursor catches
        # the chain head it just observed — the catch-up depth gauge
        trace.gauge("tailer_blocks_behind").set(
            float(max(0, top - self.cursor)))
        if batch:
            # trace context: each attestation's digest-derived id rides
            # every downstream span (WAL append, graph apply, and — via
            # the daemon's PendingTraces — the refresh that publishes it)
            tids = [att_trace_id(blk, s.attestation.about, s.to_payload())
                    for blk, s in zip(blocks, batch)]
            with trace.context(trace_ids=tids):
                with trace.span("service.tail_batch", n=len(batch),
                                block=top):
                    self.sink(batch, top, blocks)
            self.batches += 1
            self.attestations += len(batch)
        # blocks with only foreign/undecodable logs still advance the
        # cursor — they are processed, there is nothing to redo
        self.cursor = top
        self._persist_cursor()
        trace.metric("service.block_cursor", self.cursor)
        trace.metric("service.ingest_batches", self.batches)
        trace.metric("service.ingest_attestations", self.attestations)
        return len(batch)

    # --- supervised loop --------------------------------------------------
    def run(self, stop_event, poll_interval: float = 1.0,
            beat=None) -> None:
        """Poll until ``stop_event``; exponential backoff on failure,
        reset on success. The cursor survives every failure mode short
        of losing the checkpoint directory. ``beat`` (optional
        callable): stall-watchdog heartbeat, called every iteration —
        backoff counts as alive, a wedged RPC inside poll_once does
        not."""
        while not stop_event.is_set():
            if beat is not None:
                beat()
            try:
                self.poll_once()
                self.consecutive_failures = 0
                delay = poll_interval
            except Exception:  # noqa: BLE001 - daemon thread: ANY poll
                # failure (RPC, decode, a device fault inside the sink's
                # batched recovery) must back off and retry, not kill
                # the tailer; the cursor only moves on success
                self.consecutive_failures += 1
                self.retries += 1
                trace.metric("service.rpc_retries", self.retries)
                delay = min(
                    self.backoff_base * 2 ** (self.consecutive_failures - 1),
                    self.backoff_max)
                trace.event("service.poll_failed",
                            failures=self.consecutive_failures,
                            backoff_s=delay)
            stop_event.wait(delay)
