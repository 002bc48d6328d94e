"""Multi-worker proof pool: cache-affinity scheduling + tiered shedding.

The single-worker ``ProofJobQueue`` served one device no matter how
many the box had: the DeviceProver suspend/resume cache assumed a
single driver, so an 8-device box minted the same proofs/hour as a
1-device box and every concurrent request past depth 1 ate a blanket
429. This pool lifts both limits:

- **one worker per device** (``workers=0`` auto-detects the CUDA
  devices; an explicit count gives host-path workers on CPU boxes, so
  the tests exercise the full pool), each thread pinned to its device
  with ``torch.cuda.device`` (``provers.make_worker_env``);

- **cache-residency-aware scheduling**: jobs carry a ``cache_key``
  (default: the kind)
  and route to the worker already holding that proving key resident,
  falling back to the least-loaded worker; an idle worker steals from
  the longest queue (newest, preferably non-affine job first) so
  affinity never strands work. Hits/misses land on
  ``ptpu_proof_pool_affinity_total{result}``;

- **fair dequeue**: each worker drains its queue round-robin across
  kinds at equal priority — a burst of one kind can no longer starve
  interleaved submissions of another (regression-tested);

- **tiered admission** instead of the blanket 429:
  below the depth ``watermark`` every kind is accepted and queued;
  above it the admission floor rises one priority tier per additional
  watermark of depth (``profile`` < ``threshold`` < ``eigentrust``,
  ``provers.PROOF_PRIORITIES``) and shed kinds get a 429 with a
  ``Retry-After`` estimate; only the **byte-budget ceiling**
  (``queue_bytes`` of queued params) is a hard 503. Sheds land on
  ``ptpu_proof_pool_shed_total{kind,tier}``;

- the artifact store stays the shared terminal substrate: job ids
  are issued under the pool lock but persisted OUTSIDE it at issue
  time, so a daemon SIGKILLed with N jobs in flight across N workers
  rehydrates every one of them as ``failed: lost`` and never reissues
  an id (``rehydrate``);

- **worker lending (intra-prove shards)**: a job whose kind is in
  ``shard_kinds`` runs under a shard runner (``zk/shards.py``), so the
  prove's independent work units — commit columns per engine flush,
  host quotient row chunks, the two opening folds — land on the pool's
  shard queue and IDLE workers execute them before stealing whole
  jobs. Lending never disturbs a worker's own scheduling state: its
  queue, affinity residency and kind rotation are untouched; only
  ``lent_to`` (visible on ``GET /status``) marks the borrow. The
  merge point is deterministic (results absorbed in submission order;
  proofs byte-identical to a direct ``prove_fast`` — tested), and the
  admission/steal/rehydrate semantics extend naturally: sub-jobs
  bypass admission (their parent was admitted, and a pool busy enough
  to shed has no idle workers to lend), the shard queue IS the steal
  surface for sub-jobs (claim-from-shared-queue, FIFO), and shards are
  never persisted — a daemon SIGKILLed mid-sharded-prove rehydrates
  exactly ONE ``failed: lost`` job. Fan-out per stage is
  ``min(shard_cap, workers)``; the submitting worker always claims
  whatever no one lent a hand for, so progress never depends on idle
  capacity. ``ptpu_prove_shards_total{stage}`` counts executed units,
  ``ptpu_prove_shard_wait_seconds{stage}`` their queue wait, and
  shard spans carry ``worker=`` via the executing thread's context.

Everything is visible: ``ptpu_proof_pool_depth`` /
``_worker_depth{worker}`` / ``_queued_bytes`` / ``_workers`` gauges,
the shed/affinity/steal counters, a ``worker`` label on the
prover-stage histograms (the worker context flows into the prover
thread), and per-worker rows on ``GET /status``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field

from ..utils import trace
from ..utils.errors import EigenError
from .faults import FaultInjector


class QueueFullError(EigenError):
    """Admission rejected a job under load (HTTP 429). The blanket
    pre-pool form; :class:`ShedError` is the tiered variant carrying a
    ``Retry-After`` estimate."""

    retry_after: float | None = None

    def __init__(self, capacity: int):
        super().__init__("service_busy",
                         f"proof queue full ({capacity} jobs); retry later")


class ShedError(QueueFullError):
    """Tiered load shed: this KIND is below the current admission
    floor (higher-priority kinds are still being accepted).
    ``self.kind`` stays the EigenError taxonomy discriminator
    (``service_busy`` — generic handlers branch on it); the shed JOB
    kind lives on ``job_kind``."""

    def __init__(self, job_kind: str, depth: int, watermark: int,
                 retry_after: float):
        EigenError.__init__(
            self, "service_busy",
            f"proof pool shedding {job_kind!r} jobs at depth {depth} "
            f"(watermark {watermark}); retry in ~{retry_after:.0f}s")
        self.job_kind = job_kind
        self.retry_after = retry_after


class ByteBudgetError(EigenError):
    """The hard ceiling: queued job params exceed ``queue_bytes``
    (HTTP 503 — the pool is protecting its memory, not prioritizing)."""

    def __init__(self, queued_bytes: int, budget: int):
        super().__init__(
            "over_capacity",
            f"proof pool byte budget exhausted ({queued_bytes}B queued "
            f"of {budget}B); hard-shedding all kinds")


@dataclass
class ProofJob:
    job_id: str
    kind: str
    params: dict
    status: str = "queued"  # queued | running | done | failed | cancelled
    submitted_at: float = field(default_factory=time.time)
    started_at: float | None = None
    finished_at: float | None = None
    result: dict | None = None
    error: str | None = None
    cache_key: str | None = None  # affinity routing key (not persisted
    # as identity — recomputed per submit; None = no prover residency)
    worker: str | None = None     # which pool worker executed it
    _bytes: int = 0               # admission byte estimate (params)

    def to_json(self) -> dict:
        out = {
            "job_id": self.job_id,
            "kind": self.kind,
            "status": self.status,
            "submitted_at": self.submitted_at,
            "params": self.params,
        }
        if self.started_at is not None:
            out["started_at"] = self.started_at
        if self.finished_at is not None:
            out["finished_at"] = self.finished_at
        if self.result is not None:
            out["result"] = self.result
        if self.error is not None:
            out["error"] = self.error
        if self.worker is not None:
            out["worker"] = self.worker
        return out

    @classmethod
    def from_json(cls, data: dict) -> "ProofJob":
        """Inverse of :meth:`to_json` — the artifact-store rehydration
        path. Tolerates records from older layouts (missing params)."""
        return cls(
            job_id=str(data["job_id"]),
            kind=str(data.get("kind", "")),
            params=dict(data.get("params") or {}),
            status=str(data.get("status", "done")),
            submitted_at=float(data.get("submitted_at", 0.0)),
            started_at=data.get("started_at"),
            finished_at=data.get("finished_at"),
            result=data.get("result"),
            error=data.get("error"),
            worker=data.get("worker"),
        )


# absolute backlog bound, in watermarks: past this depth even the
# top-priority tier sheds (429 + Retry-After). The byte ceiling bounds
# MEMORY, but tiny-params jobs barely dent it — without a depth cap a
# priority-exempt kind could 202-accumulate a multi-day device-time
# backlog ("backpressure, not OOM" was the pre-pool queue's invariant,
# restored here one tier up)
DEPTH_CAP_WATERMARKS = 8


def _affinity_prefix(key: str) -> str:
    """The prover-identity prefix of a cache key: keys compose as
    ``kind-kNN-<identity digest>`` and the resident state a worker
    actually holds (parsed pk, DeviceProver) depends only on the
    ``kind-kNN`` part — the digest names the attestation-set epoch the
    job was submitted under. Matching falls back to the prefix so a
    membership change (new digest every interned peer) rotates the
    epoch WITHOUT spuriously invalidating every worker's warm prover
    state. Kind-only default keys have no digest and are their own
    prefix."""
    return key.rsplit("-", 1)[0] if "-" in key else key


def _detect_devices() -> list:
    """The CUDA devices (one worker each); none on a host without a
    card, whose workers are host-path workers."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class PoolWorker:
    """One worker's scheduling state. All mutable fields are guarded by
    the POOL lock (one lock for the whole scheduler — queue ops are
    microseconds against minutes-scale proves; job ids and artifact
    persists happen outside it)."""

    def __init__(self, index: int, name: str, device=None):
        self.index = index
        self.name = name
        self.device = device
        self.lent_to = None   # job id whose shard this worker is
        # executing (idle-worker lending; own queue/affinity untouched)
        self.shards_run = 0
        # kind -> FIFO deque; the OrderedDict rotation IS the fairness:
        # pop from the first non-empty kind, then move that kind to the
        # end, so kinds at equal priority round-robin instead of a
        # burst of one kind starving the others
        self.kinds: "OrderedDict[str, deque]" = OrderedDict()
        self.queued = 0
        # cache keys whose prover state this worker holds resident
        # (MRU, bounded to the DeviceProver cache cap)
        self.resident: OrderedDict = OrderedDict()
        self.running: ProofJob | None = None
        self.thread: threading.Thread | None = None
        self.jobs_run = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.stolen = 0

    @property
    def load(self) -> int:
        return self.queued + (1 if self.running is not None else 0)

    def push(self, job: ProofJob) -> None:
        self.kinds.setdefault(job.kind, deque()).append(job)
        self.queued += 1

    def pop_next(self) -> ProofJob | None:
        """Round-robin across kinds: take the oldest job of the first
        non-empty kind, then rotate that kind to the back."""
        for kind in list(self.kinds):
            q = self.kinds[kind]
            if not q:
                continue
            job = q.popleft()
            self.kinds.move_to_end(kind)
            if not q:
                del self.kinds[kind]
            self.queued -= 1
            return job
        return None

    def pop_for_steal(self) -> ProofJob | None:
        """Give up the NEWEST job, preferring one not affine to this
        worker (affine jobs keep their warm-cache spot; the thief eats
        the miss). Affinity here is prefix-aware like routing — an
        epoch-rotated key still names warm state this worker holds."""
        resident_prefixes = {_affinity_prefix(k) for k in self.resident}
        best_kind = None
        for kind in list(self.kinds):
            q = self.kinds[kind]
            if not q:
                continue
            if best_kind is None:
                best_kind = kind
            key = q[-1].cache_key
            if key is None or (
                    key not in self.resident
                    and _affinity_prefix(key) not in resident_prefixes):
                best_kind = kind
                break
        if best_kind is None:
            return None
        q = self.kinds[best_kind]
        job = q.pop()
        if not q:
            del self.kinds[best_kind]
        self.queued -= 1
        return job

    def status_row(self) -> dict:
        return {
            "worker": self.name,
            "device": str(self.device) if self.device is not None
            else "host",
            "queued": self.queued,
            "running": self.running.job_id if self.running else None,
            "jobs_run": self.jobs_run,
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "stolen": self.stolen,
            "lent_to": self.lent_to,
            "shards_run": self.shards_run,
            "resident": list(self.resident),
        }


class _ShardRunner:
    """Worker-lending shard runner for ONE running job (duck-types the
    ``zk/shards.py`` runner contract; installed by ``_run_job`` around
    shardable prover calls). ``dispatch`` parks units on the pool's
    shared shard queue and wakes idle workers; ``rendezvous`` claims
    whatever nobody lent a hand for — the submitting worker is always
    a sufficient executor, so a fully-busy pool degenerates to the
    unsharded serial order — waits for every claimed unit, and
    re-raises the first error in submission order.

    Sub-jobs deliberately bypass admission: their parent job was
    admitted (and still holds exactly one depth slot), and a pool deep
    enough to shed has no idle workers to lend anyway. They are never
    persisted: SIGKILL mid-sharded-prove rehydrates ONE failed:lost
    job, not N sub-records.

    Cross-process fabric (``zk/fabric.py``): when the pool carries a
    fabric with live external ``prove-worker`` registrations, dispatch
    ALSO publishes each unit's portable form — external processes race
    the in-process lenders for the same units. The rendezvous prefers a
    valid remote result (applied on the submitting thread, in
    submission order, so placement never moves a transcript byte),
    waits briefly on a LIVE external lease, and claims anything
    unleased or lease-lapsed for local execution — a SIGKILLed fleet
    degrades to the serial in-process order, never a hang (the lease
    TTL bounds every wait)."""

    def __init__(self, pool: "ProofWorkerPool", job: ProofJob,
                 fanout: int):
        self.pool = pool
        self.job = job
        self.fanout = fanout

    def dispatch(self, units: list) -> None:
        fabric = self.pool.fabric
        if fabric is not None:
            # publish BEFORE the units become claimable in-process: a
            # local run frees commit scalars as it finishes, and the
            # payload build must see pristine inputs. Best-effort and
            # gated on live external workers — with none registered
            # there is no serialization tax at all.
            try:
                live = fabric.workers_live()
            except Exception:  # noqa: BLE001 - fabric is optional
                live = 0
            if live > 0:
                for u in units:
                    if u.portable is None:
                        continue
                    try:
                        fabric.publish(self.job.job_id, u)
                    except Exception:  # noqa: BLE001 - local path wins
                        u.fabric_id = None
        with self.pool._lock:
            for u in units:
                u.job_id = self.job.job_id
                self.pool._shards.append(u)
            self.pool._wake.notify_all()

    def _claim(self, u) -> bool:
        """Claim ``u`` for this thread (off the lending deque); False
        when a lent worker beat us to it."""
        with self.pool._lock:
            if u.claimed:
                return False
            u.claimed = True
            try:
                self.pool._shards.remove(u)
            except ValueError:  # pragma: no cover - already
                pass            # off the queue (racing pop)
            return True

    def _apply_remote(self, unit, remote) -> None:
        """Fold an external worker's result into the unit on the
        submitting thread. Emits the same ``prove.shard`` span/counter
        the local run would — under the EXTERNAL worker's name, so
        `obs --trace-id <job>` shows which process computed the unit.
        ANY decode/apply failure falls back to the local closure:
        execution is deterministic, so the overwrite is byte-safe."""
        obj, worker_name, remote_wall = remote
        t0 = time.perf_counter()
        try:
            with contextlib.ExitStack() as stack:
                if unit.trace_ids:
                    stack.enter_context(
                        trace.context(trace_ids=unit.trace_ids))
                stack.enter_context(trace.worker_context(worker_name))
                with trace.span("prove.shard", stage=unit.stage,
                                index=unit.index, remote=1):
                    trace.counter("prove_shards").inc(stage=unit.stage)
                    unit.result = unit.portable.apply(obj)
            trace.counter("fabric_units").inc(stage=unit.stage)
            # source="local" is THIS thread's decode+apply wall;
            # source="remote" is the worker's own measured execution
            # wall carried back in the result frame — the honest
            # remote sample (absent only for older workers' frames)
            trace.histogram("fabric_unit_seconds").observe(
                time.perf_counter() - t0, stage=unit.stage,
                source="local")
            if remote_wall is not None:
                trace.histogram("fabric_unit_seconds").observe(
                    float(remote_wall), stage=unit.stage,
                    source="remote")
            unit.done.set()
        except BaseException:  # noqa: BLE001 - remote is best-effort
            trace.event("fabric.apply_failed", unit=unit.fabric_id,
                        stage=unit.stage)
            unit.run()

    def rendezvous(self, units: list) -> None:
        pool = self.pool
        fabric = pool.fabric if any(u.fabric_id is not None
                                    for u in units) else None
        while True:
            progress = False
            waiting = False
            for u in units:
                if u.done.is_set() or u.claimed:
                    continue
                remote = None
                lease = "none"
                if fabric is not None and u.fabric_id is not None:
                    try:
                        remote = fabric.try_result(u.fabric_id)
                        if remote is None:
                            lease = fabric.lease_state(u.fabric_id)
                    except Exception:  # noqa: BLE001 - run locally
                        remote, lease = None, "none"
                if remote is None and lease == "live":
                    # an external worker owns the lease: give it its
                    # TTL — a dead worker's lease lapses and the next
                    # pass reclaims the unit, so this never hangs
                    waiting = True
                    continue
                if not self._claim(u):
                    continue  # a lent worker took it meanwhile
                if remote is not None:
                    self._apply_remote(u, remote)
                else:
                    if lease == "expired":
                        trace.counter("fabric_leases_expired").inc()
                        with contextlib.suppress(Exception):
                            fabric.clear_lease(u.fabric_id)
                    u.run()
                progress = True
            if not waiting:
                break
            if not progress:
                time.sleep(pool.fabric_poll)
        for u in units:
            # claimed by a lent worker: the worker always completes a
            # claimed unit (the claim and the run are not separated by
            # a stop check), so this join cannot hang on hard_kill
            u.done.wait()
        if fabric is not None:
            with contextlib.suppress(Exception):
                for u in units:
                    if u.fabric_id is not None:
                        fabric.retire(u.fabric_id)
        err = next((u.error for u in units if u.error is not None), None)
        if err is not None:
            raise err


class ProofWorkerPool:
    """Bounded multi-worker pool + MRU result history.

    ``provers``: registry ``kind -> fn(params) -> dict`` shared by all
    workers (per-worker state — the DeviceProver caches — lives behind
    ``worker_env``, not in the registry). ``cache_key_fn(kind, params)``
    computes the affinity key (default: the kind itself, so injected
    test provers still exercise affinity). ``worker_env(worker)``
    returns a context manager entered for a worker thread's lifetime
    (the daemon installs the per-worker device pin
    there). ``watermark=0`` defaults to ``capacity``;
    ``priorities=None`` makes every kind priority 0 — the blanket
    pre-pool behavior (everything sheds at the watermark), which is
    exactly what the legacy ``ProofJobQueue`` subclass wants."""

    def __init__(self, provers: dict, capacity: int = 8,
                 faults: FaultInjector | None = None,
                 history: int = 256, artifacts=None,
                 workers: int | None = None,
                 priorities: dict | None = None,
                 default_priority: int = 0,
                 cache_key_fn=None,
                 watermark: int = 0,
                 queue_bytes: int = 4 << 20,
                 resident_keys: int = 2,
                 worker_env=None,
                 shard_kinds=None,
                 shard_cap: int = 4,
                 fabric=None,
                 fabric_poll: float = 0.05):
        self.provers = dict(provers)
        self.capacity = capacity
        self.artifacts = artifacts
        self.faults = faults or FaultInjector({"rpc": 0.0, "device": 0.0})
        self.priorities = dict(priorities or {})
        self.default_priority = int(default_priority)
        self.cache_key_fn = cache_key_fn or (lambda kind, params: kind)
        self.watermark = int(watermark) or int(capacity)
        self.queue_bytes = int(queue_bytes)
        self.resident_keys = max(1, int(resident_keys))
        self.worker_env = worker_env
        # intra-prove sharding: kinds whose jobs run under a worker-
        # lending shard runner (None/empty = off: whole jobs only);
        # per-stage fan-out is min(shard_cap, workers)
        self.shard_kinds = frozenset(shard_kinds or ())
        self.shard_cap = int(shard_cap)
        self._shards: deque = deque()  # pending ShardUnits (all jobs)
        # cross-process fabric (zk/fabric.py FabricStore or None):
        # dispatch publishes portable units when external prove-worker
        # processes are registered; fabric_poll paces the rendezvous's
        # wait on a live external lease
        self.fabric = fabric
        self.fabric_poll = float(fabric_poll)
        devices = _detect_devices()
        # clamp: a negative/zero explicit count must not build an empty
        # pool (healthy daemon, every submit crashing in _route)
        n_workers = (max(1, int(workers)) if workers
                     else max(1, len(devices)))
        if devices and n_workers > len(devices):
            # oversubscription is a HOST-PATH configuration (CPU boxes,
            # tier-1, the smoke): two caches driving one accelerator
            # would break the per-device single-driver contract the
            # suspend/resume protocol relies on (HBM budgeting assumes
            # one cache suspends what the other proves with) — warn
            # loudly rather than silently time-slicing a chip
            trace.event("pool.device_oversubscribed",
                        workers=n_workers, devices=len(devices))
        self.workers = [
            PoolWorker(i, f"w{i}",
                       devices[i % len(devices)] if devices else None)
            for i in range(n_workers)
        ]
        self._jobs: OrderedDict = OrderedDict()  # job_id -> ProofJob
        self._history = history
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._killed = False
        self._draining = False
        self._ids = itertools.count(1)
        self._queued_bytes = 0
        self._reserved = 0  # jobs admitted but not yet on a queue (the
        # artifact persist runs between the two lock sections; admission
        # must count them or N concurrent submits race past the
        # watermark/byte ceiling against stale totals)
        self._avg_run_s = 30.0  # EMA of job run seconds (Retry-After)
        self.completed = 0
        self.failed = 0
        self.shed: dict = {}  # (kind, tier) -> count (status page copy)
        self._last_done: dict = {}  # kind -> newest done job id (the
        # signed score bundle attaches the latest ET proof id; tracked
        # on completion + rehydration so a restart keeps serving it)

    # --- introspection ----------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return sum(w.queued for w in self.workers)

    def _depth_locked(self) -> int:
        return sum(w.queued for w in self.workers)

    def _record_depth(self) -> None:
        """Legacy metric, typed gauge, and the pool gauges in lockstep
        (dashboards scrape all of them; every depth change must land
        everywhere). Caller holds the lock."""
        depth = self._depth_locked()
        trace.metric("service.proof_queue_depth", depth)
        trace.gauge("proof_queue_depth").set(depth)
        trace.gauge("proof_pool_depth").set(depth)
        trace.gauge("proof_pool_queued_bytes").set(self._queued_bytes)
        for w in self.workers:
            trace.gauge("proof_pool_worker_depth").set(
                w.queued, worker=w.name)

    def pool_status(self) -> dict:
        """Per-worker rows + admission state for ``GET /status``."""
        fabric_row = None
        if self.fabric is not None:
            try:  # outside the lock: status() walks the fabric dir
                fabric_row = self.fabric.status()
            except Exception:  # noqa: BLE001
                fabric_row = {"error": "unreadable"}
        with self._lock:
            return {
                "workers": [w.status_row() for w in self.workers],
                "depth": self._depth_locked(),
                "watermark": self.watermark,
                "queue_bytes": self.queue_bytes,
                "queued_bytes": self._queued_bytes,
                "avg_run_seconds": round(self._avg_run_s, 3),
                "shed": {f"{kind}:{tier}": n
                         for (kind, tier), n in sorted(self.shed.items())},
                "shard_kinds": sorted(self.shard_kinds),
                "shards_pending": len(self._shards),
                "fabric": fabric_row,
            }

    # --- admission --------------------------------------------------------
    def _admit(self, kind: str, params: dict) -> int:
        """Tiered admission check AND reservation (caller holds the
        lock): on success the job's bytes and a depth slot are reserved
        immediately, so the N-1 concurrent submits racing through the
        unlocked artifact persist are counted against the ceiling and
        watermark, not invisible to them. Returns the byte estimate;
        raises :class:`ByteBudgetError` at the hard ceiling,
        :class:`ShedError` when the kind's priority sits below the
        current floor. Callers release the reservation when the job
        lands on a queue (or is drain-cancelled)."""
        try:
            job_bytes = len(json.dumps(params)) + 256
        except (TypeError, ValueError):
            job_bytes = 1024
        if self._queued_bytes + job_bytes > self.queue_bytes:
            self._count_shed(kind, "bytes")
            raise ByteBudgetError(self._queued_bytes, self.queue_bytes)
        depth = self._depth_locked() + self._reserved
        if depth >= self.watermark * DEPTH_CAP_WATERMARKS:
            # the absolute device-time backlog bound: no priority is
            # exempt (see DEPTH_CAP_WATERMARKS) — still a 429 retry
            # signal, not the byte ceiling's memory-protection 503
            retry = min(600.0, max(
                1.0, depth * self._avg_run_s / len(self.workers)))
            self._count_shed(kind, "depth_cap")
            raise ShedError(kind, depth, self.watermark, retry)
        if depth >= self.watermark:
            # the admission floor rises one tier per additional
            # watermark of depth — [w, 2w) sheds priority <1 (profile),
            # [2w, 3w) sheds <2 (threshold too) — but is CAPPED at the
            # registry's top priority, so the highest-priority kind is
            # only ever stopped by the byte ceiling above. With no
            # priorities configured (every kind at the 0 default) the
            # cap is 1: everything sheds at the watermark — the legacy
            # blanket behavior.
            top = max(self.priorities.values(),
                      default=self.default_priority)
            floor = min(
                1 + (depth - self.watermark) // max(self.watermark, 1),
                max(top, 1))
            prio = self.priorities.get(kind, self.default_priority)
            if prio < floor:
                retry = min(600.0, max(
                    1.0, depth * self._avg_run_s / len(self.workers)))
                self._count_shed(kind, f"tier{floor}")
                raise ShedError(kind, depth, self.watermark, retry)
        self._reserved += 1
        self._queued_bytes += job_bytes
        return job_bytes

    def _count_shed(self, kind: str, tier: str) -> None:
        self.shed[(kind, tier)] = self.shed.get((kind, tier), 0) + 1
        trace.counter("proof_pool_shed").inc(kind=kind, tier=tier)

    # --- submission / lookup ----------------------------------------------
    def submit(self, kind: str, params: dict | None = None) -> ProofJob:
        if kind not in self.provers:
            raise EigenError(
                "validation_error",
                f"unknown proof kind {kind!r}; have "
                f"{sorted(self.provers)}")
        params = dict(params or {})
        try:
            # OUTSIDE the lock: the daemon's key fn hashes the current
            # identity set on a revision change (O(peers)) and touches
            # the graph lock — neither may stall worker dequeues,
            # steals, or /status reads behind the pool lock
            cache_key = self.cache_key_fn(kind, params)
        except Exception:  # noqa: BLE001 - a key is an optimization,
            cache_key = None  # never a reason to reject a job
        with self._lock:
            if self._draining or self._stop:
                raise EigenError("service_busy",
                                 "service is draining; not accepting jobs")
            job_bytes = self._admit(kind, params)
            job = ProofJob(job_id=f"job-{next(self._ids)}", kind=kind,
                           params=params)
            job._bytes = job_bytes
            job.cache_key = cache_key
            self._jobs[job.job_id] = job
            # bound the lookup table by evicting the OLDEST TERMINAL
            # jobs; the excess is sized off the terminal count alone, so
            # queued/running entries can never shrink the history
            # allowance (nor be dropped themselves). Evicted jobs remain
            # reachable through the artifact store when one is wired.
            terminal = [j.job_id for j in self._jobs.values()
                        if j.status in ("done", "failed", "cancelled")]
            for jid in terminal[:len(terminal) - self._history]:
                del self._jobs[jid]
        if self.artifacts is not None:
            # persist the id at ISSUE time, OUTSIDE the lock (an fsync
            # must not stall lookups/health/the workers) but BEFORE the
            # job is runnable — it is not on any worker queue yet, so no
            # worker can race a terminal record under this queued one. A
            # daemon SIGKILLed with N jobs in flight must not reissue
            # any id after restart: rehydrate() advances the counter
            # past every PERSISTED id.
            try:
                self.artifacts.persist(job)
            except BaseException:
                # persist() contractually swallows OSError, but a
                # serialization failure propagates — the reservation
                # must not outlive the submit, or ghost depth sheds
                # every later job on an idle pool
                with self._lock:
                    self._reserved -= 1
                    self._queued_bytes -= job._bytes
                    job.status = "failed"
                    job.finished_at = time.time()
                    job.error = "failed: could not persist job record"
                raise
        with self._lock:
            self._reserved -= 1  # the slot either becomes real queue
            # depth (push below) or is released with the cancel
            if self._draining or self._stop:
                # drain began between the sections: this job was never
                # runnable; its queued artifact rehydrates as failed/lost
                job.status = "cancelled"
                job.finished_at = time.time()
                job.error = "cancelled: service shutdown"
                self._queued_bytes -= job._bytes
                raise EigenError("service_busy",
                                 "service is draining; not accepting jobs")
            target = self._route(job)
            target.push(job)
            self._wake.notify_all()
            self._record_depth()
            trace.event("service.job_submitted", trace_id=job.job_id,
                        kind=kind, worker=target.name,
                        depth=self._depth_locked())
            return job

    def _holds(self, w: PoolWorker, key: str) -> bool:
        """Worker ``w`` can serve ``key`` warm: exact cache key or the
        same prover by prefix (see :func:`_affinity_prefix`)."""
        if key in w.resident:
            return True
        prefix = _affinity_prefix(key)
        return any(_affinity_prefix(k) == prefix for k in w.resident)

    def _route(self, job: ProofJob) -> PoolWorker:
        """Cache-residency-aware placement: the least-loaded worker
        already holding the job's proving key (exact cache key, else
        the same prover by prefix), else the least-loaded worker
        overall. Caller holds the lock."""
        candidates = self.workers
        if job.cache_key is not None:
            holders = [w for w in self.workers
                       if self._holds(w, job.cache_key)]
            if holders:
                candidates = holders
        return min(candidates, key=lambda w: (w.load, w.index))

    def get(self, job_id: str) -> ProofJob | None:
        with self._lock:
            job = self._jobs.get(job_id)
        if job is None and self.artifacts is not None:
            data = self.artifacts.load(job_id)
            if data is not None:
                job = ProofJob.from_json(data)
        return job

    def rehydrate(self) -> int:
        """Reload the newest persisted terminal jobs into the MRU (call
        before :meth:`start`) and advance the id counter past every
        persisted id; returns how many were loaded. Jobs persisted as
        queued/running — any number of them, one per worker plus the
        queued backlog at SIGKILL — rehydrate as ``failed: lost``.
        Without an artifact store this is a no-op. Residual window: an
        id whose artifact persist FAILED (disk fault) can be reissued
        after a restart — with a disk that broken, its result was
        already lost."""
        if self.artifacts is None:
            return 0
        ids = self.artifacts.job_ids()
        top = self.artifacts.max_numeric_id()
        loaded = 0
        with self._lock:
            for jid in ids[-self._history:]:
                data = self.artifacts.load(jid)
                if data is None:
                    continue
                job = ProofJob.from_json(data)
                if job.status in ("queued", "running"):
                    # persisted at issue time, daemon died mid-job: give
                    # the polling client an honest terminal answer
                    job.status = "failed"
                    job.error = "lost: daemon restarted mid-job"
                    job.finished_at = time.time()
                    self.artifacts.persist(job)
                if job.status == "done":
                    # ids ascend, so the last done per kind survives
                    self._last_done[job.kind] = jid
                self._jobs[jid] = job
                loaded += 1
            self._ids = itertools.count(top + 1)
        return loaded

    def latest_done(self, kind: str) -> str | None:
        """Newest successfully-completed job id of ``kind`` (this
        process + rehydrated history) — what the signed score bundle
        cites as the latest EigenTrust proof."""
        with self._lock:
            return self._last_done.get(kind)

    # --- workers ----------------------------------------------------------
    def start(self, beats=None) -> None:
        """``beats`` (optional ``watchdog.Heartbeats``): each worker
        heartbeats at the top of every loop iteration — idle workers
        wake at least every 0.5s, so only a wedged prove (native call
        that never returns) ages a worker's heartbeat."""
        self._beats = beats
        trace.gauge("proof_pool_workers").set(float(len(self.workers)))
        for w in self.workers:
            if beats is not None:
                beats.register(f"ptpu-proof-{w.name}")
            w.thread = threading.Thread(
                target=self._run_worker, args=(w,), daemon=True,
                name=f"ptpu-proof-{w.name}")
            w.thread.start()

    def _steal(self, thief: PoolWorker) -> ProofJob | None:
        """Work conservation: an idle worker takes the newest
        (preferably non-affine) job from the most-loaded queue. Caller
        holds the lock."""
        victim = max((w for w in self.workers if w.queued > 0),
                     key=lambda w: w.queued, default=None)
        if victim is None or victim is thief:
            return None
        job = victim.pop_for_steal()
        if job is not None:
            thief.stolen += 1
            trace.counter("proof_pool_stolen").inc(worker=thief.name)
        return job

    def _run_worker(self, w: PoolWorker) -> None:
        # a broken worker environment (a dead CUDA context)
        # backend) must DEGRADE — no per-worker isolation/pinning —
        # not silently kill the thread while the API keeps 202-ing
        # jobs onto a queue nobody drains
        env = None
        if self.worker_env is not None:
            try:
                env = self.worker_env(w)
                env.__enter__()
            except Exception as e:  # noqa: BLE001 - degrade, don't die
                trace.event("pool.worker_env_failed", worker=w.name,
                            error=str(e))
                env = None
        try:
            with trace.worker_context(w.name):
                self._worker_loop(w)
        finally:
            beats = getattr(self, "_beats", None)
            if beats is not None:
                # a drained/killed worker is RETIRED, not stalled
                beats.unregister(f"ptpu-proof-{w.name}")
            if env is not None:
                with contextlib.suppress(Exception):
                    env.__exit__(None, None, None)

    def _worker_loop(self, w: PoolWorker) -> None:
        beats = getattr(self, "_beats", None)
        while True:
                if beats is not None:
                    beats.beat(f"ptpu-proof-{w.name}")
                unit = None
                with self._lock:
                    if self._killed:
                        # hard_kill: the backlog must stay QUEUED (a
                        # real SIGKILL would never run it) — only the
                        # graceful drain finishes pending work
                        return
                    job = w.pop_next()
                    if job is None and self._shards:
                        # worker lending: before committing an idle
                        # worker to a whole stolen job, hand it a shard
                        # of a RUNNING prove — the unit is sub-second
                        # and unblocks a client already mid-wait. The
                        # worker's own queue always wins over lending
                        # (its jobs carry their own latency budget).
                        unit = self._shards.popleft()
                        unit.claimed = True
                        w.lent_to = unit.job_id
                    elif job is None:
                        job = self._steal(w)
                    if job is None and unit is None:
                        if self._stop:
                            return
                        self._wake.wait(timeout=0.5)
                        continue
                    if job is not None:
                        # same lock hold as the pop: drain() must never
                        # observe the job off a queue but not running
                        job.status = "running"
                        job.started_at = time.time()
                        job.worker = w.name
                        w.running = job
                        self._queued_bytes -= job._bytes
                        if job.cache_key is not None:
                            # hit = this worker's prover state serves
                            # the job warm (exact key or same-prover
                            # prefix)
                            if self._holds(w, job.cache_key):
                                w.affinity_hits += 1
                                trace.counter("proof_pool_affinity").inc(
                                    result="hit")
                            else:
                                w.affinity_misses += 1
                                trace.counter("proof_pool_affinity").inc(
                                    result="miss")
                        # keep the depth honest on the DRAIN side too:
                        # a submit-only gauge would report a stale
                        # backlog forever after the queues empty
                        self._record_depth()
                if unit is not None:
                    # outside the lock: the unit's MSM/quotient compute
                    # is milliseconds-to-seconds of native work. A
                    # claimed unit ALWAYS runs to completion — there is
                    # no stop check between claim and run, so the
                    # rendezvous join can never hang on a kill.
                    try:
                        unit.run()
                    finally:
                        with self._lock:
                            w.lent_to = None
                            w.shards_run += 1
                    continue
                self._run_job(w, job)

    def _fabric_workers(self) -> int:
        """Live external prove-worker registrations (0 without a
        fabric). Best-effort: a fabric read failure must never stall
        the scheduler — it just means no external fan-out this pass."""
        if self.fabric is None:
            return 0
        try:
            return int(self.fabric.workers_live())
        except Exception:  # noqa: BLE001
            return 0

    def _shard_scope(self, job: ProofJob):
        """The worker-lending runner for a shardable job's prover call
        (no-op context otherwise). Imported lazily: a pool with
        sharding off — every injected-prover test — never
        touches the zk layer. Fan-out 1 (single worker, no external
        fleet) installs nothing: splitting work for no one costs slice
        copies. External fabric workers COUNT toward the fan-out — a
        1-worker daemon with 4 registered prove-workers must fan past
        1 or the fleet never receives a unit."""
        fanout = min(self.shard_cap,
                     len(self.workers) + self._fabric_workers())
        if job.kind not in self.shard_kinds or fanout <= 1:
            return contextlib.nullcontext()
        from ..zk.shards import shard_scope

        return shard_scope(_ShardRunner(self, job, fanout))

    def _run_job(self, w: PoolWorker, job: ProofJob) -> None:
        # queue wait vs prove time: the two halves of a client's
        # submit→done latency a single total would conflate
        trace.histogram("proof_wait_seconds").observe(
            job.started_at - job.submitted_at, kind=job.kind)
        try:
            self.faults.check("device")
            # the job id IS the trace id: /proofs/<id> polls and the
            # JSONL stream join on the same string. Prover stage spans
            # (prove_tpu.* / prove.*) run on THIS thread inside the
            # context — and under the worker context, so `obs
            # --trace-id <job>` shows the per-stage decomposition WITH
            # the worker that executed it.
            with trace.context(trace_id=job.job_id):
                with trace.span("service.proof", kind=job.kind):
                    with self._shard_scope(job):
                        result = self.provers[job.kind](job.params)
            job.result = result
            job.status = "done"
        except Exception as e:  # noqa: BLE001 - job isolation: one
            # failed prove must not kill the worker or the daemon
            job.error = str(e)
            job.status = "failed"
        finally:
            job.finished_at = time.time()
            run_s = job.finished_at - job.started_at
            with self._lock:
                w.running = None
                w.jobs_run += 1
                if job.status == "done":
                    self.completed += 1
                    self._last_done[job.kind] = job.job_id
                else:
                    self.failed += 1
                # EMA feeds the Retry-After estimate the shed path hands
                # out; seeded at 30s, converges onto the real mix
                self._avg_run_s += 0.2 * (run_s - self._avg_run_s)
                if job.cache_key is not None:
                    # this worker now holds the job's prover state
                    # resident (MRU, bounded like the DeviceProver
                    # cache) — later same-key jobs route here
                    w.resident[job.cache_key] = True
                    w.resident.move_to_end(job.cache_key)
                    while len(w.resident) > self.resident_keys:
                        w.resident.popitem(last=False)
            trace.histogram("proof_run_seconds").observe(
                run_s, kind=job.kind, status=job.status,
                worker=w.name)
            if self.artifacts is not None:
                # best-effort: persist() counts its own failures
                # (injected disk faults included) and never raises —
                # a lost artifact must not take a worker down
                self.artifacts.persist(job)
            trace.metric("service.proofs_done", self.completed)
            trace.metric("service.proofs_failed", self.failed)

    # --- lifecycle --------------------------------------------------------
    def drain(self, timeout: float = 30.0) -> bool:
        """Stop accepting, finish queued + running jobs within
        ``timeout``, then stop the workers. Jobs still pending after
        the budget are marked cancelled. Returns True on a clean
        drain."""
        with self._lock:
            self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if (self._depth_locked() == 0
                        and all(w.running is None for w in self.workers)):
                    break
            time.sleep(0.05)
        cancelled = []
        with self._lock:
            clean = self._depth_locked() == 0
            for w in self.workers:
                job = w.pop_next()
                while job is not None:
                    cancelled.append(job)
                    job = w.pop_next()
            for job in cancelled:
                job.status = "cancelled"
                job.finished_at = time.time()
                job.error = "cancelled: service shutdown"
                # exact release per job: a submit parked in its persist
                # window still holds a reservation it will release
                # itself, so zeroing the total here would double-free
                self._queued_bytes -= job._bytes
            self._record_depth()  # drained/cancelled: scrapes during
            # the drain window must not report a backlog
            self._stop = True
            self._wake.notify_all()
        if self.artifacts is not None:
            # cancelled ids must be persisted too: rehydrate() advances
            # the id counter past persisted ids only, and a restarted
            # daemon must never reissue an id a client is still polling
            for job in cancelled:
                self.artifacts.persist(job)
        alive = False
        for w in self.workers:
            if w.thread is not None:
                w.thread.join(
                    timeout=max(0.0, deadline - time.monotonic()) + 1.0)
                alive = alive or w.thread.is_alive()
        return clean and not alive

    def hard_kill(self) -> None:
        """Test seam simulating SIGKILL: stop the workers with NO
        drain, NO cancellation, NO terminal persists — queued jobs are
        left un-run and in-flight jobs stay persisted as
        queued/running, exactly what a crashed daemon leaves behind
        for :meth:`rehydrate`. (A job already executing finishes its
        prover call — threads cannot be killed mid-C-call — but no new
        work is picked up.)"""
        with self._lock:
            self._stop = True
            self._killed = True
            self._wake.notify_all()
        for w in self.workers:
            if w.thread is not None:
                w.thread.join(timeout=10)
