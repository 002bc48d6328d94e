"""Incident flight recorder: SLO-triggered autopsy bundles.

A latched ``ptpu_slo_alert`` tells an operator *that* something burned,
not *why* — by the time anyone looks, the tracer's bounded span ring
has rotated past the event and the gauge state reflects recovery, not
the failure. The flight recorder closes that gap with the black-box
pattern:

- :class:`FlightRecorder` keeps an always-on, bounded in-memory ring
  of notable moments — recent spans (sampled from the tracer on each
  capture), compile events, SLO state transitions, watchdog stall
  dumps, metric-delta samples — cheap enough to run forever.
- When the SLO engine latches an alert, the stall watchdog fires, or
  an operator POSTs ``/incidents/capture``, :meth:`capture` freezes
  the ring and writes a content-addressed bundle under
  ``<state-dir>/incidents/<id>/``: metrics snapshot, SLO window
  state, fleet registry rows, effective config, every thread's stack
  (named ``ptpu-*`` threads — the watchdog satellite), and the ring
  as JSONL.
- Captures are rate-limited (a flapping SLO must not write bundles in
  a loop) and retention is bounded (oldest bundles evicted); both are
  config knobs.
- :func:`render_autopsy` turns a bundle into the human-readable
  timeline the ``incident`` CLI verb prints.

Device-cost attribution rides along: :class:`PlanCostRegistry` holds
per-plan flops and bytes of one routed sweep, computed at plan
adoption by :func:`capture_routed_plan_cost` from the operator's static
shapes (the route-stage count, the edge and state lane counts and the
value width), and exports them as ``ptpu_plan_*`` gauges so autopsies
can put device-side cost next to host walls. The operand figure is the
resident size of the operator's device arrays, not an allocator
reading.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import threading
import time
import traceback

from ..utils import trace

# ring capacity: moments, not bytes — each entry is one small dict
RING_CAP = 2048
# spans sampled from the tracer into each bundle
SPAN_SAMPLE = 512


def thread_stacks() -> dict:
    """Every live thread's stack, keyed by thread name (the ``ptpu-*``
    naming satellite is what makes this readable). Safe anywhere: the
    dump is a snapshot, never a pause."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    out = {}
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        name = t.name if t is not None else f"ident-{ident}"
        out[name] = {
            "ident": ident,
            "daemon": bool(t.daemon) if t is not None else None,
            "stack": traceback.format_stack(frame),
        }
    return out


class FlightRecorder:
    """Bounded ring of notable moments + SLO transition memory."""

    def __init__(self, cap: int = RING_CAP):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._ring: list = []
        self._seq = 0

    def note(self, kind: str, **fields) -> None:
        """Append one moment; O(1), never blocks on I/O."""
        entry = {"t": time.time(), "kind": kind, **fields}
        with self._lock:
            self._seq += 1
            entry["seq"] = self._seq
            self._ring.append(entry)
            if len(self._ring) > self.cap:
                del self._ring[: len(self._ring) - self.cap]

    def freeze(self) -> list:
        """A point-in-time copy of the ring (the bundle's timeline)."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class PlanCostRegistry:
    """Per-compiled-plan device-cost rows, exported as ``ptpu_plan_*``
    gauges. Keyed by plan name (e.g. ``spmv_routed``); last capture
    wins — the daemon rebuilds plans rarely and the current plan is
    the one autopsies should attribute."""

    def __init__(self):
        self._lock = threading.Lock()
        self._plans: dict = {}

    def record(self, plan: str, flops: float | None,
               bytes_accessed: float | None, operand_bytes: float,
               **extra) -> None:
        row = {"plan": plan, "captured_at": time.time(),
               "flops": flops, "bytes_accessed": bytes_accessed,
               "operand_bytes": operand_bytes, **extra}
        with self._lock:
            self._plans[plan] = row
        if flops is not None:
            trace.gauge("plan_flops").set(float(flops), plan=plan)
        if bytes_accessed is not None:
            trace.gauge("plan_bytes_accessed").set(
                float(bytes_accessed), plan=plan)
        trace.gauge("plan_operand_bytes").set(
            float(operand_bytes), plan=plan)

    def rows(self) -> list:
        with self._lock:
            return [dict(r) for r in self._plans.values()]

    def get(self, plan: str) -> dict | None:
        with self._lock:
            row = self._plans.get(plan)
            return dict(row) if row else None


# the process-global registry: plan builds happen deep in refresh.py
# where no service handle exists, same pattern as trace.TRACER
PLAN_COSTS = PlanCostRegistry()


def routed_sweep_cost(op, value_bytes: int) -> tuple:
    """``(flops, bytes_accessed, operand_bytes)`` of one routed sweep of
    ``op`` (a ``RoutedOperator``) with ``value_bytes``-wide values and
    uint8 route indices. Each pass reads its inputs once and writes its
    output once:

    - broadcast: the bucket weights and the state vector in, the
      ``2^edge_e`` edge values out (one multiply a weight);
    - edge route: each stage reads ``2^edge_e`` values and indices and
      writes ``2^edge_e`` values;
    - reduce: the edge values in, the ``2^state_e`` row sums out (one
      add an edge value);
    - state route: as the edge route over ``2^state_e`` lanes;
    - dangling + damping: the score, routed base, valid, dangling and
      pre-trust vectors in, the next score out (about five operations
      a slot)."""
    vb = int(value_bytes)
    e = 1 << int(op.edge_e)
    st = 1 << int(op.state_e)
    weights = sum(int(w.size) for w in op.out_weight)
    edge_idx = sum(int(s.size) for s in op.edge_stages)
    state_idx = sum(int(s.size) for s in op.state_stages)
    n_edge, n_state = len(op.edge_stages), len(op.state_stages)
    flops = weights + e + 5 * st
    bytes_accessed = (vb * (weights + st + e)            # broadcast
                      + n_edge * 2 * vb * e + edge_idx   # edge route
                      + vb * (e + st)                    # reduce
                      + n_state * 2 * vb * st + state_idx
                      + 6 * vb * st)                     # dangling
    operand_bytes = vb * weights + edge_idx + state_idx + 3 * vb * st
    return float(flops), float(bytes_accessed), float(operand_bytes)


def capture_routed_plan_cost(op, dtype=None,
                             registry: PlanCostRegistry | None = None,
                             recorder: FlightRecorder | None = None) -> dict | None:
    """Cost attribution for the routed matvec plan, at plan adoption:
    the analytic row of :func:`routed_sweep_cost` at ``dtype``'s width
    (float32 when None) under the reference's ``spmv_routed`` name."""
    import torch

    registry = PLAN_COSTS if registry is None else registry
    vb = torch.empty(0, dtype=dtype or torch.float32).element_size()
    flops, bytes_accessed, operand_bytes = routed_sweep_cost(op, vb)
    registry.record("spmv_routed", flops, bytes_accessed, operand_bytes,
                    n_state=int(op.n_state))
    if recorder is not None:
        recorder.note("plan_cost", plan="spmv_routed", flops=flops,
                      bytes_accessed=bytes_accessed,
                      operand_bytes=operand_bytes)
    return registry.get("spmv_routed")


def update_device_memory_gauges() -> None:
    """Live device-memory gauges from the CUDA caching allocator
    (``torch.cuda.memory_stats``) for each card; on a host without one
    the series are absent, not zeros."""
    try:
        import torch

        if not torch.cuda.is_available():
            return
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue
            for key, gauge in (("allocated_bytes.all.current",
                                "device_bytes_in_use"),
                               ("allocated_bytes.all.peak",
                                "device_peak_bytes_in_use")):
                if key in stats:
                    trace.gauge(gauge).set(float(stats[key]),
                                           device=f"cuda:{i}")
    except Exception:  # noqa: BLE001 - observability must not fail
        pass


class IncidentStore:
    """Rate-limited, retention-bounded incident bundles on disk.

    One bundle = one directory ``<dir>/<id>/`` of JSON artifacts; the
    id is content-addressed over the trigger + capture time so two
    daemons sharing a state dir can never collide. ``capture`` is
    thread-safe and never raises — an incident plane that can crash
    its host daemon is worse than no incident plane."""

    def __init__(self, root: str, recorder: FlightRecorder,
                 retention: int = 16, min_interval: float = 30.0):
        self.root = root
        self.recorder = recorder
        self.retention = int(retention)
        self.min_interval = float(min_interval)
        self._lock = threading.Lock()
        self._last_capture = 0.0
        os.makedirs(root, exist_ok=True)

    # --- capture ------------------------------------------------------------

    def capture(self, trigger: str, reason: str,
                context: dict | None = None,
                force: bool = False) -> str | None:
        """Freeze the ring and write a bundle; returns the incident id
        or None when rate-limited. ``force`` (operator POST) bypasses
        the rate limit but not retention."""
        now = time.time()
        with self._lock:
            if not force and now - self._last_capture < self.min_interval:
                trace.counter("incidents_rate_limited").inc(
                    trigger=trigger)
                self.recorder.note("capture_rate_limited",
                                   trigger=trigger, reason=reason)
                return None
            self._last_capture = now
        try:
            return self._write(trigger, reason, context or {}, now)
        except Exception:  # noqa: BLE001 - never take down the daemon
            trace.counter("incidents_capture_errors").inc()
            return None

    def _write(self, trigger: str, reason: str, context: dict,
               now: float) -> str:
        digest = hashlib.sha256(
            f"{trigger}|{reason}|{now:.6f}|{os.getpid()}".encode()
        ).hexdigest()[:12]
        # microsecond, zero-padded epoch: lexicographic == chronological
        # even for captures landing within the same second
        inc_id = f"inc-{int(now * 1e6):016d}-{digest}"
        tmp = os.path.join(self.root, f".tmp-{inc_id}")
        os.makedirs(tmp, exist_ok=True)

        meta = {
            "id": inc_id,
            "captured_at": now,
            "trigger": trigger,
            "reason": reason,
            "pid": os.getpid(),
            "context": context,
        }
        self._dump(tmp, "meta.json", meta)
        self._dump(tmp, "threads.json", thread_stacks())
        self._dump(tmp, "plans.json", PLAN_COSTS.rows())
        # the frozen ring as JSONL — the autopsy's timeline
        with open(os.path.join(tmp, "ring.jsonl"), "w") as f:
            for entry in self.recorder.freeze():
                f.write(json.dumps(entry, default=str) + "\n")
        # recent spans straight off the tracer (wider than the ring);
        # recent_spans already yields plain JSON-ready dicts
        spans, _ = trace.recent_spans(limit=SPAN_SAMPLE)
        self._dump(tmp, "spans.json", list(spans))
        self._dump(tmp, "compile.json", trace.compile_stats())
        for name, obj in context.items():
            # caller-supplied big artifacts (metrics text, SLO state,
            # fleet rows, config) land as their own files
            if name.endswith(".txt"):
                with open(os.path.join(tmp, name), "w") as f:
                    f.write(str(obj))
            else:
                self._dump(tmp, f"{name}.json", obj)
        os.replace(tmp, os.path.join(self.root, inc_id))
        trace.counter("incidents_captured").inc(trigger=trigger)
        self.recorder.note("incident_captured", id=inc_id,
                           trigger=trigger, reason=reason)
        self._evict()
        return inc_id

    @staticmethod
    def _dump(root: str, name: str, obj) -> None:
        with open(os.path.join(root, name), "w") as f:
            json.dump(obj, f, default=str, indent=1)

    def _evict(self) -> None:
        ids = self.list_ids()
        excess = len(ids) - self.retention
        for inc_id in ids[:max(excess, 0)]:
            shutil.rmtree(os.path.join(self.root, inc_id),
                          ignore_errors=True)
            trace.counter("incidents_evicted").inc()
        trace.gauge("incidents_retained").set(
            float(min(len(ids), self.retention)))

    # --- read side ----------------------------------------------------------

    def list_ids(self) -> list:
        try:
            names = [n for n in os.listdir(self.root)
                     if n.startswith("inc-")]
        except OSError:
            return []
        # inc-<padded epoch-us>-<digest>: lexicographic == chronological
        return sorted(names)

    def index(self) -> list:
        rows = []
        for inc_id in self.list_ids():
            meta = self._read(inc_id, "meta.json")
            if meta:
                rows.append({k: meta.get(k) for k in
                             ("id", "captured_at", "trigger", "reason")})
        return rows

    def load(self, inc_id: str) -> dict | None:
        """The whole bundle as one dict (the ``GET /incidents/<id>``
        body). Rejects path-traversal ids outright."""
        if os.sep in inc_id or inc_id != os.path.basename(inc_id):
            return None
        root = os.path.join(self.root, inc_id)
        if not os.path.isdir(root):
            return None
        bundle = {}
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            if name.endswith(".jsonl"):
                with open(path) as f:
                    bundle[name[:-6]] = [json.loads(ln)
                                         for ln in f if ln.strip()]
            elif name.endswith(".json"):
                bundle[name[:-5]] = self._read(inc_id, name)
            elif name.endswith(".txt"):
                with open(path) as f:
                    bundle[name] = f.read()
        return bundle

    def _read(self, inc_id: str, name: str):
        try:
            with open(os.path.join(self.root, inc_id, name)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


def render_autopsy(bundle: dict) -> str:
    """The human-readable autopsy the ``incident`` CLI verb prints:
    what tripped, the ring timeline around the burn, top spans by
    wall, recompile state, per-plan device cost, thread stacks."""
    meta = bundle.get("meta") or {}
    lines = []
    ts = meta.get("captured_at")
    when = time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(ts)) if ts else "?"
    lines.append(f"incident {meta.get('id', '?')}")
    lines.append(f"  captured  {when}")
    lines.append(f"  trigger   {meta.get('trigger', '?')}: "
                 f"{meta.get('reason', '')}")

    slo = bundle.get("slo") or {}
    alerts = slo.get("alerts") or []
    if alerts:
        lines.append(f"  latched   {', '.join(alerts)}")
        for row in slo.get("slos", []):
            if row.get("slo") in alerts:
                burn = row.get("burn", {})
                lines.append(
                    f"            {row['slo']}: burn fast="
                    f"{burn.get('fast', 0):.2f} slow="
                    f"{burn.get('slow', 0):.2f} "
                    f"(objective {row.get('objective')})")

    ring = bundle.get("ring") or []
    if ring:
        lines.append(f"\ntimeline (last {min(len(ring), 20)} of "
                     f"{len(ring)} ring entries):")
        for entry in ring[-20:]:
            t = time.strftime("%H:%M:%S",
                              time.localtime(entry.get("t", 0)))
            kind = entry.get("kind", "?")
            rest = {k: v for k, v in entry.items()
                    if k not in ("t", "kind", "seq")}
            lines.append(f"  {t}  {kind:<22} "
                         + " ".join(f"{k}={v}" for k, v in rest.items()))

    spans = bundle.get("spans") or []
    if spans:
        by_wall = sorted(spans,
                         key=lambda s: -(s.get("duration_s") or 0))
        lines.append("\ntop spans by wall:")
        for s in by_wall[:10]:
            lines.append(f"  {s.get('duration_s', 0):>9.4f}s  "
                         f"{s.get('name', '?')}")

    compile_stats = bundle.get("compile") or {}
    if compile_stats:
        lines.append(
            f"\nxla: compiles={compile_stats.get('compiles', 0)} "
            f"steady_recompiles="
            f"{compile_stats.get('steady_recompiles', 0)} "
            f"recompile_warning="
            f"{compile_stats.get('recompile_warning')}")

    plans = bundle.get("plans") or []
    if plans:
        lines.append("\ndevice cost per compiled plan "
                     "(ptpu_plan_* series):")
        for p in plans:
            flops = p.get("flops")
            ba = p.get("bytes_accessed")
            fl = f"{flops:.3e}" if flops is not None else "n/a"
            bas = f"{ba:.3e}" if ba is not None else "n/a"
            lines.append(
                f"  {p.get('plan', '?'):<16} flops={fl} "
                f"bytes_accessed={bas} "
                f"operand_bytes={p.get('operand_bytes', 0):.0f}")

    fabric = bundle.get("fabric")
    if fabric:
        lines.append(f"\nfabric: {json.dumps(fabric, default=str)}")

    threads = bundle.get("threads") or {}
    if threads:
        lines.append(f"\nthreads ({len(threads)}):")
        for name in sorted(threads):
            info = threads[name]
            stack = info.get("stack") or []
            tail = stack[-1].strip().split("\n")[0] if stack else "?"
            lines.append(f"  {name:<24} {tail}")
    return "\n".join(lines) + "\n"
