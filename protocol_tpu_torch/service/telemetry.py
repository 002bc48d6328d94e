"""Fleet telemetry plane: snapshot shipping, the leader's instance
registry, and the federated ``/fleet`` + ``/fleet/metrics`` views.

PRs 13/17 made the daemon a *fleet* — a leader, ``serve --follow``
replicas, and external ``prove-worker`` processes — but observability
still ended at each process boundary: every process rendered its own
``/metrics`` and JSONL spans never left the box. This module closes
the loop:

- :func:`snapshot` serializes one process's full instrument state
  (``utils/trace.py`` counters/gauges/histograms + the legacy scalar
  gauges) plus a bounded window of its recent JSONL spans, stamped
  with ``instance``/``role``;
- :class:`TelemetryPusher` ships snapshots periodically — followers
  and ``prove-worker --url`` POST to the leader's ``/telemetry``,
  filesystem-transport workers drop them under
  ``<state-dir>/fabric/telemetry/`` (atomic tmp+rename, the fabric's
  own discipline) for the leader to sweep;
- :class:`TelemetryRegistry` is the leader's TTL'd per-instance table
  (same liveness discipline as the fabric worker registry: a row past
  its TTL reads ``active=False`` — but it is NEVER silently dropped;
  ``/fleet`` stays staleness-honest and only the bounded-capacity
  eviction forgets an instance). Shipped spans are re-emitted into
  the leader's JSONL stream carrying ``instance``, which is what lets
  ``obs --trace-id <job> --jsonl <worker stream>`` join one proof
  job's tailer→pool→``prove.shard(remote=1)``→external-worker chain;
- :func:`render_fleet_metrics` renders the union of local + reported
  instrument state as ONE exposition page with ``instance``/``role``
  labels on every series (the same rendering grammar
  ``service/metrics.py`` lints, declared once per family);
- :func:`fleet_rows` / :func:`fleet_gauge_view` are the aggregated
  operator JSON behind ``GET /fleet`` and the fleet-wide gauge inputs
  the SLO engine evaluates. Both treat the ``-1`` pre-publish
  freshness/lag sentinels as "no data", never as a negative sample.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .. import __version__
from ..utils import trace
from ..utils.errors import EigenError
from .metrics import (
    MONOTONIC_METRICS,
    _fmt,
    _fmt_le,
    _labels_text,
    _sanitize,
)

# hard caps: a telemetry report is untrusted input from the fleet's
# own processes — bound it anyway so one misbehaving sender cannot
# balloon the leader's memory or its JSONL stream
MAX_INSTANCES = 64
SPAN_WINDOW_CAP = 512
MAX_REPORT_BYTES = 4 << 20

# gauge names whose -1.0 means "no data yet" (pre-publish freshness,
# pre-first-poll replication lag) — fleet aggregation and the SLO
# engine must skip them, not average them in
SENTINEL_GAUGES = frozenset({
    "score_freshness_seconds",
    "repl_lag_seconds",
    "service.score_freshness_seconds",
})


def set_build_info(instance: str, role: str) -> None:
    """Declare this process's fleet identity: stamp every subsequent
    trace record (`trace.set_identity`) and emit the info-style
    ``ptpu_build_info{role,instance,version} 1`` gauge so federated
    series are attributable even before the first telemetry report."""
    trace.set_identity(instance, role)
    trace.gauge("build_info").set(
        1.0, role=role, instance=instance, version=__version__)


def snapshot(instance: str, role: str, extra: dict | None = None,
             summary: dict | None = None, span_after: int = 0,
             span_limit: int = 256):
    """``(report dict, span cursor)``: one process's shippable
    telemetry state. ``extra`` adds service-local legacy gauges (the
    ``extra_metrics()`` dict); ``summary`` is the role-specific
    operator digest ``/fleet`` renders per instance."""
    instruments = []
    for inst in trace.TRACER.instruments():
        if inst.kind == "histogram":
            instruments.append({
                "name": inst.name, "kind": "histogram",
                "buckets": list(inst.buckets),
                "series": [[[list(kv) for kv in items],
                            {"counts": list(s["counts"]),
                             "sum": s["sum"], "count": s["count"]}]
                           for items, s in inst.series()],
            })
        else:
            instruments.append({
                "name": inst.name, "kind": inst.kind,
                "samples": [[[list(kv) for kv in items], value]
                            for items, value in inst.samples()],
            })
    gauges = dict(trace.TRACER.metrics_latest())
    if extra:
        gauges.update(extra)
    spans, cursor = trace.recent_spans(after_id=span_after,
                                       limit=min(span_limit,
                                                 SPAN_WINDOW_CAP))
    report = {
        "v": 1,
        "instance": str(instance),
        "role": str(role),
        "version": __version__,
        "sent_at": time.time(),
        "instruments": instruments,
        "gauges": {str(k): float(v) for k, v in gauges.items()},
        "summary": dict(summary) if summary else {},
        "spans": spans,
    }
    return report, cursor


def validate_report(obj) -> str | None:
    """Error string for a malformed telemetry report, None when ok."""
    if not isinstance(obj, dict):
        return "report is not a JSON object"
    if not isinstance(obj.get("instance"), str) or not obj["instance"]:
        return "missing/empty instance"
    if not isinstance(obj.get("role"), str) or not obj["role"]:
        return "missing/empty role"
    if not isinstance(obj.get("instruments", []), list):
        return "instruments is not a list"
    if not isinstance(obj.get("gauges", {}), dict):
        return "gauges is not an object"
    if not isinstance(obj.get("spans", []), list):
        return "spans is not a list"
    return None


class TelemetryRegistry:
    """The leader's TTL'd per-instance report table.

    Liveness mirrors the fabric worker registry: a report older than
    ``ttl`` makes the instance ``active=False``. Staleness-honesty
    rule: dead instances stay listed (with their report age) — only
    the ``MAX_INSTANCES`` capacity bound evicts, oldest report first.
    """

    def __init__(self, ttl: float = 30.0):
        self.ttl = float(ttl)
        self.reports = 0
        self._lock = threading.Lock()
        self._instances: dict = {}  # instance -> row

    def report(self, obj: dict) -> dict:
        err = validate_report(obj)
        if err is not None:
            raise EigenError("validation_error",
                             f"bad telemetry report: {err}")
        instance = obj["instance"]
        role = obj["role"]
        now = time.monotonic()
        with self._lock:
            self._instances[instance] = {
                "snapshot": obj, "role": role, "seen": now,
                "received_wall": time.time(),
            }
            if len(self._instances) > MAX_INSTANCES:
                # capacity eviction only — never TTL pruning — so a
                # dead instance stays visible on /fleet
                oldest = min(self._instances,
                             key=lambda k: self._instances[k]["seen"])
                del self._instances[oldest]
            self.reports += 1
        trace.counter("telemetry_reports").inc(role=role)
        # land the shipped span window in THIS process's JSONL stream:
        # the records already carry instance/role (recent_spans stamps
        # them), so a merged obs view attributes them correctly
        for span in obj.get("spans", ())[:SPAN_WINDOW_CAP]:
            if trace.validate_record(span) is None:
                span.setdefault("instance", instance)
                span.setdefault("role", role)
                trace.emit_record(span)
        return {"ok": True, "instance": instance,
                "spans_accepted": len(obj.get("spans", ()))}

    def rows(self, now: float | None = None) -> list:
        """Staleness-honest per-instance rows, newest report first."""
        now = time.monotonic() if now is None else now
        with self._lock:
            items = sorted(self._instances.items(),
                           key=lambda kv: -kv[1]["seen"])
            out = []
            for instance, row in items:
                age = max(0.0, now - row["seen"])
                out.append({
                    "instance": instance,
                    "role": row["role"],
                    "report_age_seconds": round(age, 3),
                    "active": age <= self.ttl,
                    "snapshot": row["snapshot"],
                })
            return out

    def snapshots(self, active_only: bool = True) -> list:
        """``[(snapshot, report_age_seconds, active)]`` for rendering."""
        return [(r["snapshot"], r["report_age_seconds"], r["active"])
                for r in self.rows()
                if r["active"] or not active_only]

    def sweep_dir(self, root: str) -> int:
        """Ingest file-dropped reports (``<fabric>/telemetry/*.json``,
        the filesystem-transport worker path) and remove them; returns
        the number ingested. Torn/corrupt files are skipped — the
        writer's atomic rename makes them mean "not a report"."""
        try:
            names = sorted(os.listdir(root))
        except OSError:
            return 0
        ingested = 0
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(root, name)
            try:
                with open(path, "rb") as f:
                    data = f.read(MAX_REPORT_BYTES + 1)
                if len(data) <= MAX_REPORT_BYTES:
                    self.report(json.loads(data))
                    ingested += 1
            except (OSError, ValueError, EigenError):
                pass
            try:
                os.unlink(path)
            except OSError:
                pass
        return ingested


class TelemetryPusher:
    """The non-leader side: periodically snapshot this process's
    instrument/span state and ship it to the leader.

    ``target`` is either the leader's base URL (``http://…`` → POST
    ``/telemetry``) or a directory (the fabric file-drop transport).
    ``collect`` is the service's ``extra_metrics``-style callable —
    invoked per push so per-scrape gauges (score freshness, repl lag)
    are fresh in the snapshot; ``summary`` returns the role-specific
    ``/fleet`` digest. Push failures are never fatal: they count into
    ``ptpu_telemetry_push_failures_total`` and back off."""

    def __init__(self, target: str, instance: str, role: str,
                 interval: float = 2.0, collect=None, summary=None,
                 timeout: float = 5.0, span_limit: int = 256):
        self.target = target
        self.instance = str(instance)
        self.role = str(role)
        self.interval = max(0.05, float(interval))
        self.collect = collect
        self.summary = summary
        self.timeout = float(timeout)
        self.span_limit = int(span_limit)
        self.pushes = 0
        self.failures = 0
        self._span_cursor = 0
        self._is_http = target.startswith(("http://", "https://"))

    def build(self) -> dict:
        extra = {}
        digest = {}
        try:
            if self.collect is not None:
                extra = self.collect() or {}
        except Exception:  # noqa: BLE001 - telemetry must not bite
            extra = {}
        try:
            if self.summary is not None:
                digest = self.summary() or {}
        except Exception:  # noqa: BLE001
            digest = {}
        report, self._pending_cursor = snapshot(
            self.instance, self.role, extra=extra, summary=digest,
            span_after=self._span_cursor, span_limit=self.span_limit)
        return report

    def _send(self, report: dict) -> None:
        body = json.dumps(report).encode()
        if self._is_http:
            import urllib.request

            req = urllib.request.Request(
                self.target.rstrip("/") + "/telemetry", data=body,
                method="POST",
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            return
        # file-drop transport: atomic publish into the fabric dir
        os.makedirs(self.target, exist_ok=True)
        path = os.path.join(self.target, self.instance + ".json")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(body)
        os.replace(tmp, path)

    def push_once(self) -> bool:
        t0 = time.perf_counter()
        try:
            self._send(self.build())
        except Exception:  # noqa: BLE001 - shipping is best-effort
            self.failures += 1
            trace.counter("telemetry_push_failures").inc()
            return False
        # advance the span cursor only on success so an unreached
        # leader sees the window again (at-least-once shipping)
        self._span_cursor = self._pending_cursor
        self.pushes += 1
        trace.histogram("telemetry_push_seconds").observe(
            time.perf_counter() - t0)
        return True

    def run(self, stop: threading.Event, tick=None) -> None:
        """Push until ``stop``; consecutive failures back off up to
        8× the interval. ``tick()`` (optional) runs every pass — the
        follower threads its SLO sampling through here."""
        failures = 0
        while not stop.is_set():
            ok = self.push_once()
            failures = 0 if ok else min(failures + 1, 3)
            if tick is not None:
                try:
                    tick()
                except Exception:  # noqa: BLE001
                    pass
            stop.wait(self.interval * (2 ** failures))


# --- aggregation + rendering -------------------------------------------------


def _gauge_value(snap: dict, name: str):
    """A named gauge from a snapshot — typed instrument first, legacy
    dict second; sentinel-honest (negative sentinel → None)."""
    value = None
    for inst in snap.get("instruments", ()):
        if inst.get("name") == name and inst.get("kind") == "gauge":
            for items, v in inst.get("samples", ()):
                if not items:
                    value = v
    if value is None:
        gauges = snap.get("gauges", {})
        for key in (name, f"service.{name}", f"repl.{name}"):
            if key in gauges:
                value = gauges[key]
                break
    if value is None:
        return None
    if name in SENTINEL_GAUGES and float(value) < 0.0:
        return None
    return float(value)


def fleet_rows(registry: TelemetryRegistry, local: dict) -> dict:
    """The ``GET /fleet`` JSON: one row per instance (the leader's own
    ``local`` row first), never silently dropping a dead one."""
    rows = [dict(local, active=True, report_age_seconds=0.0)]
    for r in registry.rows():
        snap = r["snapshot"]
        rows.append({
            "instance": r["instance"],
            "role": r["role"],
            "active": r["active"],
            "report_age_seconds": r["report_age_seconds"],
            "version": snap.get("version"),
            "score_freshness_seconds":
                _gauge_value(snap, "score_freshness_seconds"),
            "repl_lag_seconds": _gauge_value(snap, "repl_lag_seconds"),
            "summary": snap.get("summary", {}),
        })
    by_role: dict = {}
    for row in rows:
        by_role[row["role"]] = by_role.get(row["role"], 0) + 1
    return {
        "instances": rows,
        "counts": {
            "total": len(rows),
            "active": sum(1 for r in rows if r["active"]),
            "by_role": by_role,
        },
        "ttl_seconds": registry.ttl,
    }


def fleet_gauge_view(registry: TelemetryRegistry,
                     local: dict | None = None) -> dict:
    """Fleet-wide worst-case gauges for the SLO engine: the MAX of
    each sentinel-honest gauge across the local process and every
    ACTIVE reported instance; a gauge nobody has data for is None
    ("no data", never ``-1``)."""
    out = {}
    for name in ("score_freshness_seconds", "repl_lag_seconds"):
        values = []
        if local is not None and local.get(name) is not None:
            v = float(local[name])
            if v >= 0.0 or name not in SENTINEL_GAUGES:
                values.append(v)
        for snap, _age, active in registry.snapshots(active_only=True):
            v = _gauge_value(snap, name)
            if v is not None:
                values.append(v)
        out[name] = max(values) if values else None
    return out


def update_fleet_gauges(registry: TelemetryRegistry) -> None:
    """Refresh the leader-local ``ptpu_fleet_*`` gauges from the
    registry (scraped on the leader's own ``/metrics`` too)."""
    rows = registry.rows()
    trace.gauge("fleet_instances").set(
        float(1 + sum(1 for r in rows if r["active"])))
    for r in rows:
        labels = {"instance": r["instance"], "role": r["role"]}
        trace.gauge("fleet_instance_up").set(
            1.0 if r["active"] else 0.0, **labels)
        trace.gauge("fleet_report_age_seconds").set(
            r["report_age_seconds"], **labels)


def render_fleet_metrics(registry: TelemetryRegistry, instance: str,
                         role: str, extra: dict | None = None) -> str:
    """The federated exposition page: local + every ACTIVE reported
    instrument state, ``instance``/``role`` labels injected on every
    series, each family's TYPE declared exactly once. Dead instances
    do NOT contribute frozen instrument series (their rates would
    silently flatline); their liveness is carried by the always-
    rendered ``ptpu_fleet_instance_up`` / report-age series instead.
    """
    local_snap, _ = snapshot(instance, role, extra=extra, span_limit=0)
    snaps = [(local_snap, 0.0, True)]
    snaps += registry.snapshots(active_only=True)

    # family -> {"kind", "rows": [(labels_items, payload, buckets)]}
    families: dict = {}

    def _family(name: str, kind: str):
        fam = families.get(name)
        if fam is None:
            fam = families[name] = {"kind": kind, "rows": []}
        return fam if fam["kind"] == kind else None

    for snap, _age, _active in snaps:
        inst_labels = (("instance", snap["instance"]),
                       ("role", snap["role"]))

        def _stamp(items, inst_labels=inst_labels):
            # a sample may already carry instance/role labels (e.g.
            # ptpu_build_info, the role-labelled telemetry counters) —
            # appending a second copy would duplicate the label name
            # and fail the exposition grammar; the sample's own wins
            have = {kv[0] for kv in items}
            return tuple(tuple(kv) for kv in items) + tuple(
                kv for kv in inst_labels if kv[0] not in have)

        for inst in snap.get("instruments", ()):
            name = inst.get("name", "")
            kind = inst.get("kind", "")
            if not name or name.startswith("fleet_"):
                # fleet meta-series are fleet-scoped, rendered below
                # from the registry itself — a per-instance copy would
                # double the instance label
                continue
            metric = _sanitize(f"ptpu_{name}")
            if kind == "counter":
                if not metric.endswith("_total"):
                    metric += "_total"
                fam = _family(metric, "counter")
                if fam is None:
                    continue
                for items, value in inst.get("samples", ()):
                    fam["rows"].append(
                        (_stamp(items), float(value), None))
            elif kind == "gauge":
                fam = _family(metric, "gauge")
                if fam is None:
                    continue
                for items, value in inst.get("samples", ()):
                    fam["rows"].append(
                        (_stamp(items), float(value), None))
            elif kind == "histogram":
                fam = _family(metric, "histogram")
                if fam is None:
                    continue
                buckets = tuple(inst.get("buckets", ()))
                for items, s in inst.get("series", ()):
                    fam["rows"].append((_stamp(items), s, buckets))
        for name, value in sorted(snap.get("gauges", {}).items()):
            metric = _sanitize(f"ptpu_{name}")
            if name in MONOTONIC_METRICS:
                if not metric.endswith("_total"):
                    metric += "_total"
                fam = _family(metric, "counter")
            else:
                fam = _family(metric, "gauge")
            if fam is None:
                continue
            fam["rows"].append((inst_labels, float(value), None))

    lines = []
    for metric in sorted(families):
        fam = families[metric]
        kind = fam["kind"]
        lines.append(f"# TYPE {metric} {kind}")
        emitted = set()
        for labels, payload, buckets in fam["rows"]:
            key = tuple(sorted(labels))
            if key in emitted:
                continue  # duplicate series would fail the lint
            emitted.add(key)
            if kind == "histogram":
                running = 0
                for bound, n in zip(buckets, payload["counts"]):
                    running += n
                    le = 'le="' + _fmt_le(bound) + '"'
                    lines.append(f"{metric}_bucket"
                                 f"{_labels_text(labels, le)} {running}")
                inf = 'le="+Inf"'
                lines.append(f"{metric}_bucket"
                             f"{_labels_text(labels, inf)} "
                             f"{payload['count']}")
                lines.append(f"{metric}_sum{_labels_text(labels)} "
                             f"{repr(payload['sum'])}")
                lines.append(f"{metric}_count{_labels_text(labels)} "
                             f"{payload['count']}")
            else:
                lines.append(
                    f"{metric}{_labels_text(labels)} {_fmt(payload)}")

    # fleet meta-series: every registered instance (dead ones too —
    # the up gauge IS the staleness signal), plus the leader itself
    rows = registry.rows()
    lines.append("# TYPE ptpu_fleet_instances gauge")
    lines.append(f"ptpu_fleet_instances "
                 f"{1 + sum(1 for r in rows if r['active'])}")
    lines.append("# TYPE ptpu_fleet_instance_up gauge")
    all_rows = [{"instance": instance, "role": role, "active": True,
                 "report_age_seconds": 0.0}] + rows
    for r in all_rows:
        labels = (("instance", r["instance"]), ("role", r["role"]))
        lines.append(f"ptpu_fleet_instance_up{_labels_text(labels)} "
                     f"{1 if r['active'] else 0}")
    lines.append("# TYPE ptpu_fleet_report_age_seconds gauge")
    for r in all_rows:
        labels = (("instance", r["instance"]), ("role", r["role"]))
        lines.append(
            f"ptpu_fleet_report_age_seconds{_labels_text(labels)} "
            f"{_fmt(r['report_age_seconds'])}")
    return "\n".join(lines) + "\n"
