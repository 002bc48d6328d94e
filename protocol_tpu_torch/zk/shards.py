"""Intra-prove sharding seam: addressable work units + a deterministic
result-rendezvous.

The proof pool scales proving across *jobs* (one prove per pool
worker); a single flagship prove still runs every commit column,
quotient chunk and opening fold on one worker. This module is the
zk-layer half of the intra-prove fabric: a prove declares its
independent work units (:func:`shard_map`), and whatever runner is
installed for the current thread fans them out — the proof pool
installs a worker-lending runner (``service/pool.py``) so idle workers
execute shards of a running prove; with no runner installed every unit
runs inline, which is
byte-for-byte the pre-sharding behavior.

The ordering contract (the ONLY invariant the transcript needs):
``shard_map`` returns results in SUBMISSION order no matter which
worker computed which unit or in what order they finished. Every unit
is also bit-exact regardless of placement — commit columns are
per-column bit-exact in ``g1_msm_multi`` (BENCH_r08), the quotient
kernel is pointwise per evaluation row, and the opening folds are
whole units — so a sharded prove's transcript absorbs exactly the
bytes a direct ``prove_fast`` would, proofs byte-identical (tested on
both prove paths, engine on and off).

Failure semantics: a unit that raises poisons the whole map — the
rendezvous still waits for every claimed unit (a lent worker cannot be
interrupted mid-C-call), then re-raises the first error in submission
order. Units are NEVER persisted: a shard is part of its parent job,
so a daemon SIGKILLed mid-sharded-prove rehydrates exactly one
``failed: lost`` job (pool test).

Runner duck type (the pool's ``_ShardRunner``): ``fanout`` (int, how
many units a stage should split into — 1 disables splitting),
``dispatch(units)`` (make units claimable, non-blocking) and
``rendezvous(units)`` (execute still-unclaimed units on the calling
thread, wait for the rest, raise the first error).

Observability: every executed unit counts into
``ptpu_prove_shards_total{stage}`` and observes its queue wait in
``ptpu_prove_shard_wait_seconds{stage}``; the ``prove.shard`` span runs
under the executing thread's worker context, so spans (and the JSONL
stream) carry ``worker=`` — `obs --trace-id <job>` shows which workers
a prove was lent.
"""

from __future__ import annotations

import contextlib
import threading
import time

from ..utils import trace

_TLS = threading.local()


class ShardUnit:
    """One addressable unit of a sharded stage: a closure plus its
    rendezvous state. ``claimed`` is guarded by the RUNNER's lock (the
    pool lock); ``done`` is the completion event the rendezvous waits
    on. ``run()`` is executed exactly once, by whichever thread claimed
    the unit."""

    __slots__ = ("stage", "fn", "index", "job_id", "trace_ids",
                 "result", "error", "claimed", "done", "submitted_at",
                 "portable", "fabric_id")

    def __init__(self, stage: str, fn, index: int,
                 trace_ids: tuple = (), portable=None):
        self.stage = stage
        self.fn = fn
        self.index = index
        self.job_id = None          # stamped by the pool runner
        self.trace_ids = trace_ids  # submitting thread's trace context
        self.result = None
        self.error = None
        self.claimed = False
        self.done = threading.Event()
        self.submitted_at = time.perf_counter()
        # cross-process face (zk/fabric.py): a PortableUnit the runner
        # MAY publish so an external prove-worker can execute this unit;
        # None keeps the unit thread-only. fabric_id is stamped by the
        # fabric store at publish time.
        self.portable = portable
        self.fabric_id = None

    def run(self) -> None:
        """Execute the unit on the CURRENT thread (the submitting
        thread at rendezvous, or a lent pool worker). The span runs
        under the submitter's trace ids plus the executing thread's
        worker context, so shard spans are joinable per job AND carry
        the worker that actually ran them."""
        trace.histogram("prove_shard_wait_seconds").observe(
            time.perf_counter() - self.submitted_at, stage=self.stage)
        try:
            with contextlib.ExitStack() as stack:
                if self.trace_ids:
                    stack.enter_context(
                        trace.context(trace_ids=self.trace_ids))
                with trace.span("prove.shard", stage=self.stage,
                                index=self.index):
                    trace.counter("prove_shards").inc(stage=self.stage)
                    self.result = self.fn()
        except BaseException as e:  # surfaced by the rendezvous
            self.error = e
        finally:
            self.done.set()


def current_runner():
    """The shard runner installed for THIS thread, or None (inline)."""
    return getattr(_TLS, "runner", None)


def shard_fanout() -> int:
    """How many units the current stage should split into: the
    runner's fan-out (pool: min(shard_cap, worker count)), or 1 when
    no runner is installed — callers then skip splitting entirely."""
    runner = current_runner()
    if runner is None:
        return 1
    return max(1, int(getattr(runner, "fanout", 1)))


@contextlib.contextmanager
def shard_scope(runner):
    """Install ``runner`` for the current thread (the pool wraps each
    shardable job's prover call in this). Nested scopes restore the
    previous runner on exit; runner=None explicitly disables sharding
    inside the scope."""
    prev = getattr(_TLS, "runner", None)
    _TLS.runner = runner
    try:
        yield runner
    finally:
        _TLS.runner = prev


def shard_map(stage: str, fns: list, portables: list | None = None) -> list:
    """Run ``fns`` and return their results in submission order.

    With a runner installed and more than one unit, the units are
    dispatched for lending and the calling thread joins the execution
    through ``rendezvous`` (it claims whatever no lent worker took, so
    progress never depends on anyone lending). Without a runner this
    is a plain in-order loop — the pre-sharding code path, no trace
    noise, no threading.

    ``portables`` (parallel to ``fns``, entries may be None) gives
    units a serializable face: when the pool has external fabric
    workers registered, a runner may publish those units over
    ``zk/fabric.py`` so another PROCESS executes them. Results still
    merge in submission order — placement never moves a byte."""
    runner = current_runner()
    if runner is None or len(fns) <= 1:
        return [fn() for fn in fns]
    units = [ShardUnit(stage, fn, i, trace_ids=trace.current_trace_ids(),
                       portable=portables[i] if portables else None)
             for i, fn in enumerate(fns)]
    runner.dispatch(units)
    runner.rendezvous(units)
    return [u.result for u in units]


def split_ranges(n: int, parts: int) -> list:
    """Contiguous (start, stop) covering [0, n) in ≤ ``parts`` chunks,
    sizes within one of each other — the row-slicing rule the sharded
    quotient and the engine's column splits share."""
    parts = max(1, min(int(parts), n)) if n > 0 else 1
    base, extra = divmod(n, parts)
    out = []
    start = 0
    for i in range(parts):
        stop = start + base + (1 if i < extra else 0)
        out.append((start, stop))
        start = stop
    return out
