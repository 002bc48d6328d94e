"""Legacy single-worker facade over the multi-worker proof pool.

The bounded proof job queue grew into :mod:`.pool` —
``ProofWorkerPool``: one worker per device, per-worker identity-keyed
prover caches (the DeviceProver single-driver assumption is per-worker
now — ``zk/prover_fast.worker_isolation``), cache-affinity scheduling,
and tiered load shedding in place of the blanket 429. See pool.py for
the full design.

``ProofJobQueue`` keeps the pre-pool contract for callers and tests
that want the original shape: ONE worker thread and blanket
backpressure — every kind sheds (``QueueFullError`` → HTTP 429) once
the queue holds ``capacity`` jobs. Intra-prove sharding
(``pool.shard_kinds`` worker lending) stays off here by construction:
with one worker there is nobody to lend, and the legacy queue predates
the sharded fabric. That is exactly the pool with one
worker, a watermark equal to ``capacity``, and every kind at equal
(zero) priority, so the implementation is shared rather than forked:
history eviction, artifact persistence at issue time, rehydration with
the id counter advanced past every persisted id, and drain semantics
are the pool's.
"""

from __future__ import annotations

from .pool import (  # noqa: F401 - re-exports: the public job surface
    ByteBudgetError,
    PoolWorker,
    ProofJob,
    ProofWorkerPool,
    QueueFullError,
    ShedError,
)


class ProofJobQueue(ProofWorkerPool):
    """Bounded FIFO + single worker thread + MRU result history (the
    pre-pool service shape, preserved for drop-in use)."""

    def __init__(self, provers: dict, capacity: int = 8,
                 faults=None, history: int = 256, artifacts=None):
        """``artifacts``: optional ``store.ProofArtifactStore`` —
        terminal jobs are persisted there and lookups/rehydration fall
        back to it, making proof history survive the MRU and restarts."""
        super().__init__(
            provers, capacity=capacity, faults=faults, history=history,
            artifacts=artifacts, workers=1, priorities=None,
            watermark=capacity)

    @property
    def _thread(self):
        """Back-compat: the single worker's thread."""
        return self.workers[0].thread
