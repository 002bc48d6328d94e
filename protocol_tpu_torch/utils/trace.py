"""Structured tracing + typed metrics: the port's instrumentation layer.

The counterpart of ``protocol_tpu/utils/trace.py``, copied whole: the
same instrument names, the same JSONL record schema
(:func:`validate_record`) and the same environment switches, so the two
packages' streams and ``/metrics`` series read alike. Three spots differ,
because the port runs on torch and CUDA and has no XLA:

- ``device_sync`` synchronises the CUDA device of the value it is given;
- ``device_trace`` runs ``torch.profiler`` and exports its Chrome trace
  into ``log_dir``;
- there is no compiler to listen to, so ``install_compile_tracking()``
  returns False (as the reference's does on a host without jax) and
  ``compile_stats()`` reads zero compiles. ``compile_watch`` and
  ``thread_compile_seconds`` stay, as no-ops, so callers keep the
  reference's shape.

This module provides:

- ``span(name, **fields)``: nested wall-clock spans (context manager)
  carrying ``span_id``/``parent_id`` and, when a trace context is
  active, the ``trace_id``(s) of the work items flowing through them;
- ``context(trace_id=...)`` / ``context(trace_ids=[...])``: thread-local
  trace-context propagation — a cheap id (attestation digest, job id,
  HTTP request id) stamped on every span/event emitted inside, so one
  work item's end-to-end path is joinable from the JSONL stream;
- **typed instruments** with Prometheus semantics, rendered by
  ``service/metrics.py`` with correct ``# TYPE`` metadata:
  ``counter(name)`` (monotonic, ``_total``), ``gauge(name)``, and
  ``histogram(name)`` (fixed log-spaced buckets, exact count/sum,
  ``_bucket``/``_sum``/``_count``), all label-aware (labels must be
  static strings in code — stable cardinality is the caller's contract);
- ``event(name, **fields)``: point events with arbitrary fields,
- legacy scalar samples via ``metric(name, value)`` (gauge view),
- a process-global ``Tracer`` with JSONL export and a summary table,
- ``device_trace(log_dir)``: optional ``torch.profiler`` capture for
  device-side timelines — it emits start/stop events into the JSONL
  stream carrying the log dir and the active trace ids, so a capture is
  joinable against the span stream offline;
- **sync-span mode** (``sync_spans()`` / ``PTPU_TRACE_SYNC=1``): device
  dispatch is asynchronous, so a span around a dispatch-only call
  attributes the compute cost to whichever later span happens to block.
  With sync mode on, ``device_sync(x)`` drains the device queue at span
  boundaries, making per-stage attribution accurate (at the cost of the
  production overlap — a profiling mode, not a serving default);
- **compile tracking** (:class:`CompileTracker`): the reference's XLA
  compile listener, kept with its instruments
  (``ptpu_xla_compiles_total{site}``, ``ptpu_xla_compile_seconds``) and
  ``compile_watch(site, signature)``; on torch nothing compiles, so it
  never installs and every count stays zero.

Tracing is off unless enabled — ``enable()`` in code or the
``PROTOCOL_TPU_TRACE`` env var (set to a path to also stream JSONL
there; set to ``1`` for in-memory only). Overhead when disabled is one
attribute check per call site.

Thread-safety contract: recording, JSONL emission, and ``dump_jsonl``
are all safe against concurrent mutation — emits are serialized under a
dedicated lock (no interleaved lines), and dumps snapshot the buffers
under the collector lock before touching the file.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import json
import math
import os
import threading
import time
from dataclasses import dataclass


# per-name metric history bound (samples kept for dump_jsonl); the
# latest value is never dropped — see Tracer.metric
METRIC_HISTORY_CAP = 4096

# per-span-name duration window for percentile estimates (p50/p95 on
# /stages and stage_summary): bounded per NAME so busy spans cannot
# evict quiet ones
DURATION_WINDOW_CAP = 512

# default histogram buckets: log-spaced (factor √10) from 100 µs to
# 100 s — WAL appends sit at the bottom, cold converges and proof jobs
# at the top (beyond lands in +Inf). Fixed in code so every scrape of a
# given series has identical bucket boundaries.
DEFAULT_BUCKETS = tuple(10.0 ** (e / 2.0) for e in range(-8, 5))

# ptpu_commit_batch_size counts COLUMNS per MSM batch, not seconds —
# integer buckets sized to the commit engine's grouping (K ≤ 16 per
# g1_msm_multi call). Every creation site must pass these (buckets are
# fixed at first registration): the commit engine and
# service/metrics.py declare_instruments.
COMMIT_BATCH_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)

# ptpu_refresh_frontier_rows counts frontier/sample-set ROWS per
# sublinear refresh, not seconds — decade buckets spanning one dirty
# node to a 10M-peer graph. Every creation site must pass these
# (buckets are fixed at first registration): service/refresh.py
# _record_sublinear and service/metrics.py declare_instruments.
FRONTIER_ROWS_BUCKETS = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7)


def _label_key(labels: dict) -> tuple:
    """Canonical (sorted, stringified) label identity for one series."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter (Prometheus ``counter``): only ever goes up.
    Survives :meth:`Tracer.reset` — a scraper must never see a counter
    move backwards short of a process restart."""

    kind = "counter"

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self._tracer = tracer
        self._lock = threading.Lock()
        self._values: dict = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._tracer.enabled:
            return
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + float(amount)

    def set_total(self, value: float, **labels) -> None:
        """Adopt an externally-tracked running total (e.g. an existing
        ``self.retries`` attribute); clamped monotonic — the stored
        value never decreases."""
        if not self._tracer.enabled:
            return
        key = _label_key(labels)
        with self._lock:
            self._values[key] = max(self._values.get(key, 0.0),
                                    float(value))

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list:
        """[(label_items, value)] — a consistent copy for rendering."""
        with self._lock:
            return sorted(self._values.items())


class Gauge:
    """Last-write-wins scalar (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, name: str, tracer: "Tracer"):
        self.name = name
        self._tracer = tracer
        self._lock = threading.Lock()
        self._values: dict = {}

    def set(self, value: float, **labels) -> None:
        if not self._tracer.enabled:
            return
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def samples(self) -> list:
        with self._lock:
            return sorted(self._values.items())


class Histogram:
    """Fixed-bucket latency histogram with exact count/sum (Prometheus
    ``histogram``): per label set, one non-cumulative count per bucket
    plus an overflow (+Inf) slot — rendering cumulates. Buckets are
    fixed at first registration; later ``histogram(name)`` calls reuse
    them."""

    kind = "histogram"

    def __init__(self, name: str, tracer: "Tracer", buckets=None):
        self.name = name
        self._tracer = tracer
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._lock = threading.Lock()
        self._series: dict = {}

    def observe(self, value: float, **labels) -> None:
        if not self._tracer.enabled:
            return
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"counts": [0] * (len(self.buckets) + 1),
                     "sum": 0.0, "count": 0}
                self._series[key] = s
            s["counts"][idx] += 1
            s["sum"] += value
            s["count"] += 1

    def series(self) -> list:
        """[(label_items, {counts, sum, count})] — deep-copied so the
        renderer never races an observe."""
        with self._lock:
            return sorted(
                (key, {"counts": list(s["counts"]), "sum": s["sum"],
                       "count": s["count"]})
                for key, s in self._series.items())


class PendingTraces:
    """Trace ids handed from one pipeline stage to a later asynchronous
    one, keyed by a monotonically-increasing revision: the ingest sink
    ``add``s the ids it applied at graph revision R, and the refresher
    ``take``s everything at-or-below the revision it is about to
    publish — stamping the refresh span that first reflects those work
    items. Bounded (oldest dropped) so a stalled consumer is a gap in
    the trace stream, not a leak."""

    def __init__(self, cap: int = 4096):
        self._lock = threading.Lock()
        self._items: list = []  # [(revision, trace_id)]
        self._cap = cap

    def add(self, revision: int, trace_ids) -> None:
        with self._lock:
            self._items.extend((revision, t) for t in trace_ids)
            if len(self._items) > self._cap:
                del self._items[: len(self._items) - self._cap]

    def take(self, revision: int) -> list:
        """Drain every id recorded at-or-below ``revision``."""
        with self._lock:
            taken = [t for r, t in self._items if r <= revision]
            self._items = [(r, t) for r, t in self._items if r > revision]
        return taken


class CompileTracker:
    """The reference's compile observability, kept so the instrument
    names, ``compile_stats()`` and ``compile_watch`` read alike in both
    packages: typed instruments and a steady-state recompile detector
    fed by a compile listener.

    Steady-state semantics: a compile for a (site, signature) pair that
    was already compiled once in the process means a cache that should
    have hit missed; it increments ``xla_steady_recompiles`` and latches
    :attr:`recompile_warning`.

    On torch there is no backend compile to listen to: :meth:`install`
    returns False, :meth:`_on_event` is never called, and every count
    stays zero."""

    SEEN_CAP = 4096  # signature memory bound (long-lived daemons)

    def __init__(self, tracer: "Tracer"):
        self._tracer = tracer
        self._lock = threading.Lock()
        self._local = threading.local()
        self.installed = False
        self.compiles = 0
        self.compile_seconds = 0.0
        self.steady_recompiles = 0
        self.recompile_warning = False
        self.last_site: str | None = None
        self._seen: set = set()

    def install(self) -> bool:
        """False: torch runs eagerly and has no backend compile to
        listen to, so compile tracking is a no-op (the reference's
        answer on a host without jax)."""
        return False

    def _on_event(self, event: str, duration: float, **kw) -> None:
        if event != self.EVENT or not self._tracer.enabled:
            return
        site = getattr(self._local, "site", None) or "other"
        with self._lock:
            self.compiles += 1
            self.compile_seconds += float(duration)
            self.last_site = site
        self._local.count = getattr(self._local, "count", 0) + 1
        self._local.seconds = (getattr(self._local, "seconds", 0.0)
                               + float(duration))
        self._tracer.counter("xla_compiles").inc(site=site)
        self._tracer.histogram("xla_compile_seconds").observe(
            float(duration), site=site)

    def thread_compiles(self) -> int:
        return getattr(self._local, "count", 0)

    def thread_compile_seconds(self) -> float:
        """Seconds THIS thread spent in backend compiles (the listener
        runs on the dispatching thread) — lets a timed region carve
        compile time out of its wall clock."""
        return getattr(self._local, "seconds", 0.0)

    @contextlib.contextmanager
    def watch(self, site: str, signature=None):
        """Attribute compiles inside the block to ``site``; with a
        ``signature``, latch the steady-state warning when this exact
        signature compiles a second time."""
        if not self._tracer.enabled:
            yield
            return
        self.install()
        prev = getattr(self._local, "site", None)
        self._local.site = site
        before = self.thread_compiles()
        try:
            yield
        finally:
            self._local.site = prev
            # > 0, not truthy: a concurrent reset() swaps the
            # thread-local store out from under an in-flight watch and
            # the delta goes negative — never latch or inc on that
            compiled = self.thread_compiles() - before
            if signature is not None and compiled > 0:
                key = (site, signature)
                with self._lock:
                    seen = key in self._seen
                    if not seen:
                        if len(self._seen) >= self.SEEN_CAP:
                            # bounded memory: dropping old signatures
                            # can only under-report, never false-latch
                            self._seen.pop()
                        self._seen.add(key)
                    else:
                        self.steady_recompiles += compiled
                        self.recompile_warning = True
                if seen:
                    self._tracer.counter("xla_steady_recompiles").inc(
                        compiled, site=site)
                    self._tracer.event("trace.steady_recompile",
                                       site=site, compiles=compiled)

    def reset(self) -> None:
        """Clear counters, the seen-signature set, and the warning
        latch (the listener stays installed). Test teardown seam —
        the latch is process-global, so a test that deliberately
        trips it must not leak the warning into later tests."""
        with self._lock:
            self.compiles = 0
            self.compile_seconds = 0.0
            self.steady_recompiles = 0
            self.recompile_warning = False
            self.last_site = None
            self._seen.clear()
        self._local = threading.local()

    def stats(self) -> dict:
        with self._lock:
            return {
                "installed": self.installed,
                "compiles": self.compiles,
                "compile_seconds": round(self.compile_seconds, 6),
                "steady_recompiles": self.steady_recompiles,
                "recompile_warning": self.recompile_warning,
                "last_site": self.last_site,
            }


@dataclass
class SpanRecord:
    name: str
    start: float           # EPOCH seconds (time.time at span open) —
    duration: float        # alignable with event timestamps; duration
    depth: int             # is measured on the monotonic clock
    fields: dict
    span_id: str = ""
    parent_id: str | None = None
    trace_ids: tuple = ()


class Tracer:
    """Process-global collector. Thread-safe; spans nest per-thread."""

    def __init__(self):
        self.enabled = False
        # sync-span mode: device_sync() drains the device queue at span
        # boundaries for accurate stage attribution (PTPU_TRACE_SYNC's
        # first-class form; see module docstring)
        self.sync = False
        # fleet identity: once a process knows its place in the fleet
        # (leader daemon, follower replica, prove-worker) every emitted
        # record carries instance/role — the cross-process trace join
        # needs the attribution on the records themselves, because a
        # merged view has no other way to tell the streams apart
        self.instance: str | None = None
        self.role: str | None = None
        self.compile_tracker = CompileTracker(self)
        self._lock = threading.Lock()
        self._emit_lock = threading.Lock()
        self._local = threading.local()
        self._stream = None
        self._stream_path: str | None = None
        self._stream_bytes = 0
        # size cap on the JSONL stream (PTPU_TRACE_MAX_BYTES; 0 =
        # unbounded): past it the file rotates to <path>.1
        self._stream_max_bytes = 0
        self.spans: list = []
        self.events: list = []
        # per-name duration windows for percentile estimates: bounded
        # PER NAME (unlike the shared spans list) so a high-frequency
        # span (HTTP requests) cannot evict every sample of a rare but
        # important one (refresh, prover stages) out of /stages' p50/p95
        self._durations: dict = {}
        self.metrics: dict = {}
        self._instruments: dict = {}
        self._span_ids = itertools.count(1)
        # exact running aggregates per span name: summary() stays
        # correct even after the bounded spans list drops old records
        # (a daemon emits spans indefinitely)
        self._span_agg: dict = {}

    # --- lifecycle --------------------------------------------------------
    def enable(self, stream_path: str | None = None) -> None:
        self.enabled = True
        if stream_path:
            # re-enabling onto a new path must not leak the previous
            # stream's fd (e.g. PROTOCOL_TPU_TRACE env stream replaced
            # by a CLI --jsonl flag)
            old = self._stream
            self._stream = open(stream_path, "a", buffering=1)
            self._stream_path = stream_path
            try:
                self._stream_bytes = os.fstat(
                    self._stream.fileno()).st_size
            except OSError:
                self._stream_bytes = 0
            env = os.environ.get("PTPU_TRACE_MAX_BYTES")
            try:
                self._stream_max_bytes = int(env) if env else 0
            except ValueError:
                self._stream_max_bytes = 0
            if old is not None:
                with contextlib.suppress(OSError):
                    old.close()

    def disable(self) -> None:
        self.enabled = False
        if self._stream:
            self._stream.close()
            self._stream = None
            self._stream_path = None

    def _rotate_stream_locked(self) -> None:
        """Size-based rotation of the JSONL stream: the current file
        moves to ``<path>.1`` (one rotated sibling — ``obs --jsonl``
        reads it back) and a fresh file takes its place. Called under
        ``_emit_lock`` with the size cap already exceeded; any OS
        failure leaves the original stream in place (an unbounded
        trace beats a lost one)."""
        path = self._stream_path
        if not path:
            return
        old = self._stream
        try:
            os.replace(path, path + ".1")
            new = open(path, "a", buffering=1)
        except OSError:
            # replace failed: keep appending to the original; replace
            # succeeded but reopen failed: old fd still points at the
            # rotated inode, so no record is ever dropped either way
            return
        self._stream = new
        self._stream_bytes = 0
        if old is not None:
            with contextlib.suppress(OSError):
                old.close()

    def reset(self) -> None:
        """Clear spans/events/metric histories. Typed instruments are
        deliberately KEPT: counters are monotonic for the process
        lifetime (a /metrics scrape must never see one go backwards);
        use :meth:`reset_instruments` for a full teardown (tests)."""
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self.metrics.clear()
            self._span_agg.clear()
            self._durations.clear()
        self.instance = None
        self.role = None

    def reset_instruments(self) -> None:
        with self._lock:
            self._instruments.clear()

    # --- typed instruments ------------------------------------------------
    def _instrument(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, self, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"instrument {name!r} already registered as "
                    f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._instrument(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._instrument(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._instrument(name, Histogram, buckets=buckets)

    def instruments(self) -> list:
        """Registered instruments, name-sorted (a consistent copy)."""
        with self._lock:
            return [inst for _, inst in sorted(self._instruments.items())]

    # --- trace context ----------------------------------------------------
    def new_id(self) -> str:
        """A process-unique short id (HTTP request ids, span ids)."""
        return f"{next(self._span_ids):08x}"

    def current_trace_ids(self) -> tuple:
        return getattr(self._local, "trace", ())

    @contextlib.contextmanager
    def context(self, trace_id: str | None = None, trace_ids=None):
        """Bind trace id(s) to this thread: every span/event emitted
        inside carries them (``trace_id`` when single, ``trace_ids``
        list otherwise). Nesting replaces, exit restores."""
        if not self.enabled:
            yield
            return
        ids = tuple(trace_ids) if trace_ids is not None else (
            (trace_id,) if trace_id else ())
        prev = getattr(self._local, "trace", ())
        self._local.trace = ids or prev
        try:
            yield
        finally:
            self._local.trace = prev

    def set_identity(self, instance: str, role: str) -> None:
        """Declare this process's fleet identity. Idempotent;
        subsequent spans/events carry ``instance``/``role``."""
        self.instance = str(instance)
        self.role = str(role)

    def _trace_fields(self) -> dict:
        ids = getattr(self._local, "trace", ())
        out: dict = {}
        if len(ids) == 1:
            out["trace_id"] = ids[0]
        elif ids:
            out["trace_ids"] = list(ids)
        worker = getattr(self._local, "worker", None)
        if worker is not None:
            out["worker"] = worker
        if self.instance is not None:
            out["instance"] = self.instance
            out["role"] = self.role
        return out

    # --- worker context ---------------------------------------------------
    def current_worker(self) -> str | None:
        return getattr(self._local, "worker", None)

    @contextlib.contextmanager
    def worker_context(self, name: str):
        """Bind a pool-worker identity to this thread: every span/event
        emitted inside carries ``worker: name`` (the ``obs --trace-id``
        view shows which worker executed a job's prover stages), and
        stage instruments that consult :func:`current_worker` label
        their series with it. Nesting replaces, exit restores — same
        discipline as :meth:`context`."""
        prev = getattr(self._local, "worker", None)
        self._local.worker = name
        try:
            yield
        finally:
            self._local.worker = prev

    # --- recording --------------------------------------------------------
    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        if not self.enabled:
            yield
            return
        depth = self._depth()
        stack = getattr(self._local, "stack", ())
        parent = stack[-1] if stack else None
        span_id = self.new_id()
        self._local.depth = depth + 1
        self._local.stack = stack + (span_id,)
        wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._local.depth = depth
            self._local.stack = stack
            trace_ids = getattr(self._local, "trace", ())
            worker = getattr(self._local, "worker", None)
            if worker is not None:
                # into the record's fields too, so dump_jsonl replays
                # carry the worker id exactly like the live stream
                fields.setdefault("worker", worker)
            rec = SpanRecord(name, wall, dt, depth, fields,
                             span_id=span_id, parent_id=parent,
                             trace_ids=trace_ids)
            with self._lock:
                self.spans.append(rec)
                if len(self.spans) > METRIC_HISTORY_CAP:
                    del self.spans[: len(self.spans) - METRIC_HISTORY_CAP]
                agg = self._span_agg.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
                agg["count"] += 1
                agg["total_s"] += dt
                agg["max_s"] = max(agg["max_s"], dt)
                window = self._durations.setdefault(name, [])
                window.append(dt)
                if len(window) > DURATION_WINDOW_CAP:
                    del window[: len(window) - DURATION_WINDOW_CAP]
            obj = {"type": "span", "name": name, "ts": wall,
                   "duration_s": dt, "depth": depth, "span_id": span_id}
            if parent is not None:
                obj["parent_id"] = parent
            obj.update(self._trace_fields())
            obj.update(fields)
            self._emit(obj)

    def event(self, name: str, **fields) -> None:
        if not self.enabled:
            return
        ts = time.time()
        with self._lock:
            self.events.append((ts, name, fields))
            if len(self.events) > METRIC_HISTORY_CAP:
                del self.events[: len(self.events) - METRIC_HISTORY_CAP]
        obj = {"type": "event", "ts": ts, "name": name}
        obj.update(self._trace_fields())
        obj.update(fields)
        self._emit(obj)

    def metric(self, name: str, value) -> None:
        """Record a gauge/counter sample (last-write-wins + history).
        History is bounded per name: a long-running daemon samples
        counters continuously and an unbounded list is a slow leak —
        the latest value (what /metrics serves) is always kept."""
        if not self.enabled:
            return
        with self._lock:
            hist = self.metrics.setdefault(name, [])
            hist.append(float(value))
            if len(hist) > METRIC_HISTORY_CAP:
                del hist[: len(hist) - METRIC_HISTORY_CAP]
        self._emit({"type": "metric", "name": name, "value": float(value)})

    def metrics_latest(self) -> dict:
        """{name: most recent sample} — the gauge view Prometheus-style
        exporters (``service.metrics``) render."""
        with self._lock:
            return {k: v[-1] for k, v in self.metrics.items() if v}

    def _emit(self, obj: dict) -> None:
        stream = self._stream
        if stream is not None:
            line = json.dumps(obj) + "\n"
            # one lock, one write: concurrent emitters must never
            # interleave partial JSONL lines
            with self._emit_lock:
                try:
                    stream.write(line)
                except ValueError:  # stream closed under us (disable
                    return          # racing a daemon thread's emit)
                if self._stream_max_bytes > 0:
                    self._stream_bytes += len(line)
                    if self._stream_bytes > self._stream_max_bytes:
                        self._rotate_stream_locked()

    def emit_record(self, obj: dict) -> None:
        """Append one FOREIGN record (a span shipped from another fleet
        process via ``service/telemetry.py``) to this process's JSONL
        stream verbatim — the cross-process trace join lands remote
        spans next to local ones. No-op without an open stream."""
        self._emit(obj)

    def recent_spans(self, after_id: int = 0, limit: int = 256):
        """``(records, cursor)``: the newest ≤ ``limit`` retained spans
        whose numeric span id is > ``after_id``, serialized exactly like
        :meth:`dump_jsonl` and stamped with this process's
        instance/role. ``cursor`` is the highest id serialized (pass it
        back as ``after_id`` to ship each span at most once) — span ids
        are ``new_id()`` hex, monotonic for the process lifetime."""
        with self._lock:
            recs = [r for r in self.spans
                    if r.span_id and int(r.span_id, 16) > after_id]
        recs = recs[-int(limit):] if limit else []
        out = []
        cursor = after_id
        for rec in recs:
            obj = {"type": "span", "name": rec.name, "ts": rec.start,
                   "duration_s": rec.duration, "depth": rec.depth,
                   "span_id": rec.span_id}
            if rec.parent_id is not None:
                obj["parent_id"] = rec.parent_id
            if len(rec.trace_ids) == 1:
                obj["trace_id"] = rec.trace_ids[0]
            elif rec.trace_ids:
                obj["trace_ids"] = list(rec.trace_ids)
            obj.update(rec.fields)
            if self.instance is not None:
                obj.setdefault("instance", self.instance)
                obj.setdefault("role", self.role)
            out.append(obj)
            cursor = max(cursor, int(rec.span_id, 16))
        return out, cursor

    # --- reporting --------------------------------------------------------
    def summary(self) -> dict:
        """Aggregate span stats: {name: {count, total_s, max_s}} — from
        the exact running aggregates (immune to the bounded spans list
        trimming old records)."""
        with self._lock:
            return {name: dict(agg)
                    for name, agg in self._span_agg.items()}

    def span_durations(self) -> dict:
        """{name: [duration, ...]} from the PER-NAME bounded windows
        (newest ``DURATION_WINDOW_CAP`` per span name) — the percentile
        source for :func:`stage_summary`. Estimates over the retained
        window, unlike :meth:`summary` whose aggregates are exact."""
        with self._lock:
            return {name: list(window)
                    for name, window in self._durations.items()}

    def dump_jsonl(self, path: str) -> None:
        # snapshot under the lock FIRST: a daemon thread appending
        # mid-dump must not mutate the lists we iterate
        with self._lock:
            spans = list(self.spans)
            events = list(self.events)
            metrics = {k: list(v) for k, v in self.metrics.items()}
        with open(path, "w") as f:
            for rec in spans:
                obj = {"type": "span", "name": rec.name, "ts": rec.start,
                       "duration_s": rec.duration, "depth": rec.depth,
                       "span_id": rec.span_id}
                if rec.parent_id is not None:
                    obj["parent_id"] = rec.parent_id
                if len(rec.trace_ids) == 1:
                    obj["trace_id"] = rec.trace_ids[0]
                elif rec.trace_ids:
                    obj["trace_ids"] = list(rec.trace_ids)
                obj.update(rec.fields)
                f.write(json.dumps(obj) + "\n")
            for ts, name, fields in events:
                f.write(json.dumps(
                    {"type": "event", "ts": ts, "name": name, **fields})
                    + "\n")
            for name, values in metrics.items():
                f.write(json.dumps(
                    {"type": "metric", "name": name, "values": values})
                    + "\n")


def validate_record(obj) -> str | None:
    """Schema check for one JSONL trace record (the ``obs`` CLI verb's
    stream validator); returns an error string or None when valid."""
    if not isinstance(obj, dict):
        return "record is not a JSON object"
    kind = obj.get("type")
    if kind not in ("span", "event", "metric"):
        return f"unknown record type {kind!r}"
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        return "missing/empty name"
    if kind == "span":
        if not isinstance(obj.get("duration_s"), (int, float)):
            return f"span {name!r} without numeric duration_s"
        if "span_id" in obj and not isinstance(obj["span_id"], str):
            return f"span {name!r} with non-string span_id"
    if kind == "metric":
        value = obj.get("value", obj.get("values"))
        if isinstance(value, list):
            if not all(isinstance(v, (int, float)) for v in value):
                return f"metric {name!r} with non-numeric values"
        elif not isinstance(value, (int, float)):
            return f"metric {name!r} without numeric value"
    return None


TRACER = Tracer()

if os.environ.get("PTPU_TRACE_SYNC") == "1":
    TRACER.sync = True

_env = os.environ.get("PROTOCOL_TPU_TRACE")
if _env:
    try:
        TRACER.enable(None if _env == "1" else _env)
    except OSError:  # unwritable stream path must not break imports
        TRACER.disable()
        TRACER.enabled = True  # keep in-memory tracing on


def enable(stream_path: str | None = None) -> None:
    TRACER.enable(stream_path)


def disable() -> None:
    TRACER.disable()


def span(name: str, **fields):
    return TRACER.span(name, **fields)


def event(name: str, **fields) -> None:
    TRACER.event(name, **fields)


def metric(name: str, value) -> None:
    TRACER.metric(name, value)


def counter(name: str) -> Counter:
    return TRACER.counter(name)


def counter_total(name: str, **labels) -> float:
    """Sum of a named counter's samples, optionally restricted to the
    label values given (compared stringified, the stored form) — the
    one instrument-scan idiom bench, the smoke and the tests kept
    re-implementing, each slightly differently."""
    want = {str(k): str(v) for k, v in labels.items()}
    for inst in TRACER.instruments():
        if inst.name == name and inst.kind == "counter":
            return sum(v for items, v in inst.samples()
                       if all(dict(items).get(k) == w
                              for k, w in want.items()))
    return 0.0


def gauge(name: str) -> Gauge:
    return TRACER.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return TRACER.histogram(name, buckets=buckets)


def context(trace_id: str | None = None, trace_ids=None):
    return TRACER.context(trace_id=trace_id, trace_ids=trace_ids)


def worker_context(name: str):
    return TRACER.worker_context(name)


def current_worker() -> str | None:
    return TRACER.current_worker()


def current_trace_ids() -> tuple:
    return TRACER.current_trace_ids()


def set_identity(instance: str, role: str) -> None:
    TRACER.set_identity(instance, role)


def emit_record(obj: dict) -> None:
    TRACER.emit_record(obj)


def recent_spans(after_id: int = 0, limit: int = 256):
    return TRACER.recent_spans(after_id=after_id, limit=limit)


def new_id() -> str:
    return TRACER.new_id()


def summary() -> dict:
    return TRACER.summary()


@contextlib.contextmanager
def timed(histogram_name: str, span_name: str, labels: dict | None = None,
          **fields):
    """A span that also feeds a latency histogram: the one timing idiom
    behind every stage instrument (prover stages, prove totals, the
    routed plan build), so the span/observe pairing cannot drift per
    site. ``labels`` go to the histogram series; ``fields`` to the
    span. The observation lands even when the body raises — a failed
    stage must stay visible to the histograms (and their count must
    keep matching the span count)."""
    t0 = time.perf_counter()
    try:
        with TRACER.span(span_name, **fields):
            yield
    finally:
        TRACER.histogram(histogram_name).observe(
            time.perf_counter() - t0, **(labels or {}))


# --- sync-span mode ---------------------------------------------------------

def sync_spans(enable: bool = True) -> None:
    """Turn sync-span mode on/off: :func:`device_sync` then drains the
    device queue at span boundaries, so per-stage spans attribute the
    device compute they dispatched instead of skewing it onto whichever
    later span happens to block. Profiling mode — it serializes stages,
    so totals read slightly worse than the production overlap.
    ``PTPU_TRACE_SYNC=1`` in the environment enables it at import."""
    TRACER.sync = bool(enable)


def sync_enabled() -> bool:
    return TRACER.sync


def device_sync(x):
    """Block until the CUDA work behind ``x`` (a tensor, or a tuple,
    list or dict of them) is done when sync-span mode is active;
    returns ``x`` either way. Host values and CPU tensors need no
    wait."""
    if TRACER.sync and TRACER.enabled and x is not None:
        for dev in _cuda_devices(x):
            import torch

            torch.cuda.synchronize(dev)
    return x


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists
    and dict values)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return set().union(*(_cuda_devices(v) for v in x)) if x else set()
    dev = getattr(x, "device", None)
    return {dev} if getattr(dev, "type", None) == "cuda" else set()


# --- compile tracking (no-op on torch) ---------------------------------------

def install_compile_tracking() -> bool:
    """False: there is no compiler to listen to on torch, so
    :func:`compile_stats` reads zero compiles."""
    return TRACER.compile_tracker.install()


def compile_watch(site: str, signature=None):
    """Context manager kept from the reference: it would attribute
    compiles inside to ``site``; on torch none happen, so it marks the
    region and counts nothing (see :class:`CompileTracker`)."""
    return TRACER.compile_tracker.watch(site, signature)


def thread_compile_seconds() -> float:
    """Seconds this thread spent in backend compiles: always 0.0 on
    torch (the reference diffs it across a timed region)."""
    return TRACER.compile_tracker.thread_compile_seconds()


def compile_stats() -> dict:
    return TRACER.compile_tracker.stats()


# --- percentile stage summaries ---------------------------------------------

def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of a non-empty list:
    the smallest value with at least ``q`` of the mass at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of empty list")
    rank = math.ceil(q * len(ordered))
    return ordered[max(rank, 1) - 1]


def stage_summary() -> dict:
    """Per-span-name durations with percentiles:
    ``{name: {count, total_s, max_s, p50_s, p95_s}}``. Counts/totals
    are the exact running aggregates; p50/p95 come from the bounded
    span window (daemon-safe estimates)."""
    exact = TRACER.summary()
    windows = TRACER.span_durations()
    out = {}
    for name, agg in exact.items():
        durations = windows.get(name) or []
        out[name] = {
            "count": agg["count"],
            "total_s": agg["total_s"],
            "max_s": agg["max_s"],
            "p50_s": percentile(durations, 0.50) if durations else 0.0,
            "p95_s": percentile(durations, 0.95) if durations else 0.0,
        }
    return out


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` capture of the CPU and, where there is one,
    the CUDA timeline; the Chrome trace lands in ``log_dir`` on exit.
    No-op context when the profiler cannot start, so production paths
    never die on profiler availability.

    Start/stop events land in the JSONL stream carrying ``log_dir`` and
    the active trace context, so the timeline is joinable against the
    span stream by trace id + wall-clock window."""
    prof = None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:  # noqa: BLE001 - profiler unavailable: no-op
        prof = None
    started = prof is not None
    event("trace.device_trace_start", log_dir=str(log_dir),
          started=started)
    try:
        yield
    finally:
        if started:
            with contextlib.suppress(Exception):
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(str(log_dir), f"trace-{os.getpid()}.json"))
        event("trace.device_trace_stop", log_dir=str(log_dir),
              started=started)
