"""The long-running trust-scores service on torch.

The port of the reference's ``service`` package: the daemon that stays
up, tails the AttestationStation, keeps scores fresh under churn,
survives restarts from its WAL and snapshots, and serves them over
HTTP. Module names and behaviour are the reference's; the device seams
are the port's:

- :class:`ChainTailer` (``tailer.py``) — follows the AttestationStation
  over the client's chains with retry + exponential backoff and a
  resumable block cursor (``utils/checkpoint.py``).
- :class:`OpinionGraph` (``state.py``) — the in-memory opinion graph;
  ``recover_signers`` recovers the signers of a batch on the card
  (``client.ingest.recover_signers_batch``: the Montgomery-multiply
  kernel) from 32 lanes up, and on the host below that.
- :class:`ScoreRefresher` (``refresh.py``) — warm-started refresh on
  ``TorchSparseBackend``; past ``routed_edge_threshold`` edges it runs
  ``TorchRoutedBackend`` (the route-stage kernel) with a cached
  operator, then absorbs churn in the delta engine and its ladder
  (``incremental``).
- :class:`ProofWorkerPool` (``pool.py``) — the bounded proof pool with
  affinity scheduling and tiered shedding, one worker per CUDA device;
  the default registry mints eigentrust and threshold proofs (rounds
  3–4 of every prove on the worker's card; ``provers.py``).
- ``http_api.py`` — GET /scores, /score/<addr>, /status, /metrics,
  /healthz, the replication and bundle routes, POST /proofs.
- :class:`TrustService` (``daemon.py``) — the supervisor: threads,
  SIGTERM drain, fault injection (``faults.py``), and, given a state
  dir, the durable store (``store``: WAL, snapshots, proof artifacts;
  formats shared with the reference byte for byte). With
  ``shard_proves`` the pool lends idle workers into a running prove's
  work units, and with ``fabric`` external ``prove-worker`` processes
  too (``zk/fabric.py``).
- :class:`FollowerService` (``follower.py``) — the read replica
  (``serve --follow``): bootstraps from the leader's snapshot, tails
  its shipped WAL (``replication.py``), recovers the signers and
  refreshes on its own device as the leader does, and serves
  ``/scores``, ``/score/<addr>`` and the leader's ``/bundle``
  read-only.

Wired to the CLI as the ``serve`` verb (``--follow``), ``prove-worker``,
``store inspect|compact``, ``obs`` and the operator verbs ``fleet``,
``slo`` and ``incident`` (``cli/main.py``).
"""

from .config import ServiceConfig
from .daemon import TrustService
from .faults import FaultInjector
from .follower import FollowerService
from .jobs import (
    ByteBudgetError,
    ProofJob,
    ProofJobQueue,
    ProofWorkerPool,
    QueueFullError,
    ShedError,
)
from .refresh import ScoreRefresher, ScoreTable
from .state import OpinionGraph
from .tailer import ChainTailer

__all__ = [
    "ByteBudgetError",
    "ChainTailer",
    "FaultInjector",
    "FollowerService",
    "OpinionGraph",
    "ProofJob",
    "ProofJobQueue",
    "ProofWorkerPool",
    "QueueFullError",
    "ShedError",
    "ScoreRefresher",
    "ScoreTable",
    "ServiceConfig",
    "TrustService",
]
