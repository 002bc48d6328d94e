"""Prometheus text rendering of ``utils/trace.py`` instruments + spans.

The tracer is the repo's single observability sink (every hot path
already emits spans/metrics into it); the service turns it outward:
``GET /metrics`` serves the text exposition format (version 0.0.4 — the
one every Prometheus scraper speaks) rendered from

- the tracer's **typed instruments** — ``counter`` (``_total`` suffix,
  ``# TYPE counter``), ``gauge``, and ``histogram``
  (``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets) —
  all label-aware;
- ``TRACER.metrics_latest()`` → one series per legacy scalar metric
  (``service.block_cursor`` → ``ptpu_service_block_cursor``).
  Monotonic legacy series (ingest/refresh/proof/retry counts) are
  rendered as REAL counters with a ``_total`` suffix; the old
  gauge-typed names are kept for one release as deprecated aliases so
  existing dashboards keep scraping;
- ``TRACER.summary()`` → per-span-name ``ptpu_span_total`` (counter) /
  ``ptpu_span_seconds_total`` (counter) / ``ptpu_span_seconds_max``
  (gauge) series with the span name as a label (stable cardinality:
  span names are static strings in code). ``ptpu_span_count`` remains
  as the deprecated gauge alias of ``ptpu_span_total``.

Metric names are sanitized to the Prometheus grammar
``[a-zA-Z_:][a-zA-Z0-9_:]*`` — dots become underscores. Label values
are escaped per the exposition format (backslash, quote, newline).

``lint_exposition`` is the matching pure-python validator — the
serve phase of ``chip_smoke.py`` runs it against a live ``/metrics``
page so a malformed exposition fails the check, not the first real
scraper.
"""

from __future__ import annotations

import re

from ..utils import trace

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*$")

# legacy scalar metrics that are monotonically non-decreasing by
# construction (counts of things that happened): rendered as counters
# with a _total suffix. Names already ending in _total migrate in
# place (the TYPE lie was the bug); the rest keep their old gauge name
# as a one-release deprecated alias.
MONOTONIC_METRICS = frozenset({
    "service.ingest_batches",
    "service.ingest_attestations",
    "service.invalid_attestations",
    "service.rpc_retries",
    "service.refresh_total",
    "service.refresh_cold_total",
    "service.proofs_done",
    "service.proofs_failed",
    "service.proof_completed",
    "service.proof_failed",
    "service.operator_cache_hits",
    "service.operator_builds",
    "service.delta_batches",
    "service.partial_refreshes",
    "service.device_partial_refreshes",
    "service.sampled_refreshes",
    "service.delta_reanchors",
    "store.wal_records_appended",
    "store.wal_torn_skipped",
    "store.snapshot_failures",
    "store.replayed_records",
    "store.proof_persist_failures",
    "repl.records_applied",
    "repl.polls",
    "repl.gaps",
})


# every latency histogram the instrument layer emits, with the label
# keys its quantiles aggregate over. One authoritative list: it drives
# (a) declare_instruments() — the families appear on /metrics with
# # TYPE metadata from the FIRST scrape, before the first sample — and
# (b) the reference's Prometheus recording rules, which name the same
# families.
HISTOGRAM_FAMILIES = {
    "wal_append_seconds": (),
    "wal_fsync_seconds": (),
    "snapshot_encode_seconds": (),
    "snapshot_save_seconds": (),
    "proof_persist_seconds": (),
    "refresh_seconds": ("mode",),
    "proof_wait_seconds": ("kind",),
    "proof_run_seconds": ("kind", "status", "worker"),
    "http_request_seconds": ("endpoint", "status"),
    # the worker label lands only on series observed inside a pool
    # worker context (trace.worker_context) — batch-CLI proves keep
    # the shorter label set; cardinality is bounded by the device
    # count. ``batched`` lands only on the commit.* stages (the commit
    # engine's on/off dimension).
    "prover_stage_seconds": ("stage", "k", "path", "worker", "batched"),
    "prover_total_seconds": ("k", "path", "worker"),
    # columns per MSM batch (a size histogram, not seconds): the
    # commit engine's grouping evidence — p50 near 1 means the engine
    # is running but nothing batches (grouping regression)
    "commit_batch_size": ("bases",),
    # frontier/sample-set rows per sublinear refresh (a size histogram,
    # not seconds): the freshness-vs-compute frontier evidence — mode
    # is the ladder rung that served (partial | device_partial |
    # sampled)
    "refresh_frontier_rows": ("mode",),
    "converge_sweep_seconds": ("backend", "semiring"),
    "routed_plan_build_seconds": (),
    "operator_delta_seconds": ("kind",),
    "xla_compile_seconds": ("site",),
    # queue wait of one intra-prove shard unit (submit → execution
    # start) — the lending latency of the sharded proving fabric;
    # stage is the work-unit family (commit | quotient | open_fold)
    "prove_shard_wait_seconds": ("stage",),
    # wall of one fabric unit executed by an EXTERNAL prove-worker
    # process: source="remote" is the WORKER-measured execution wall
    # (shipped back in the result frame's meta), source="local" is the
    # submitting daemon's apply wall for that remote result — the
    # honest split the fleet-observability plane aggregates
    "fabric_unit_seconds": ("stage", "source"),
    # wall of one telemetry snapshot push (follower / prove-worker →
    # leader POST /telemetry or the fabric file drop)
    "telemetry_push_seconds": (),
    # one follower replication poll: shipped-chunk fetch + local WAL
    # append + graph apply (the follower's ingest unit)
    "repl_poll_seconds": (),
}

# typed counters/gauges of the device-observability layer, declared up
# front for the same reason (the serve-smoke asserts a steady-state
# recompile count of 0 and a shed count of 0 under the watermark — the
# series must exist to be assertable)
DECLARED_COUNTERS = ("xla_compiles", "xla_steady_recompiles",
                     "operator_full_builds", "refresh_sweep_scope",
                     "proof_pool_shed", "proof_pool_affinity",
                     "proof_pool_stolen", "prove_shards",
                     "repl_chunks", "repl_records_shipped",
                     "scenario_runs", "fabric_units",
                     "fabric_leases_expired",
                     "telemetry_reports", "telemetry_push_failures",
                     # incident plane: watchdog stall detections and
                     # flight-recorder capture outcomes
                     "thread_stalls", "incidents_captured",
                     "incidents_rate_limited", "incidents_evicted",
                     "incidents_capture_errors")
DECLARED_GAUGES = ("converge_iterations", "converge_residual",
                   "proof_queue_depth", "dirty_rows",
                   "refresh_frontier_peak", "refresh_budget_spent",
                   "proof_pool_depth", "proof_pool_worker_depth",
                   "proof_pool_queued_bytes", "proof_pool_workers",
                   "repl_lag_records", "repl_lag_seconds",
                   "fabric_workers", "fabric_lease_age_seconds",
                   # info-style: build_info{role,instance,version} 1 —
                   # every fleet process emits it at boot so federated
                   # series are attributable before the first telemetry
                   # report lands
                   "build_info",
                   # leader-side fleet registry + SLO engine state
                   "fleet_instances", "fleet_instance_up",
                   "fleet_report_age_seconds",
                   "slo_burn_rate", "slo_in_budget", "slo_alert",
                   "slo_objective",
                   # incident plane: per-thread heartbeat ages / stall
                   # flags from the watchdog, retained-bundle count,
                   # and the per-plan device-cost attribution series
                   # (XLA cost_analysis at plan build; operand bytes
                   # are the lowering-side resident estimate)
                   "thread_heartbeat_age_seconds", "thread_stalled",
                   "incidents_retained",
                   "plan_flops", "plan_bytes_accessed",
                   "plan_operand_bytes",
                   "device_bytes_in_use", "device_peak_bytes_in_use")


def declare_instruments() -> None:
    """Pre-register the instrument families above so ``/metrics``
    carries their ``# TYPE`` declarations from daemon start. Histograms
    with no samples render as a bare TYPE line; counters/gauges render
    a zero default series only once touched — so the counters are
    touched with a no-op ``inc(0)`` here (monotonicity unaffected)."""
    size_buckets = {"commit_batch_size": trace.COMMIT_BATCH_BUCKETS,
                    "refresh_frontier_rows": trace.FRONTIER_ROWS_BUCKETS}
    for name in HISTOGRAM_FAMILIES:
        # the size histograms count columns/rows, not seconds — their
        # buckets are integers; creation sites must agree (first wins)
        trace.histogram(name, buckets=size_buckets.get(name))
    for name in DECLARED_COUNTERS:
        trace.counter(name).inc(0.0)
    for name in DECLARED_GAUGES:
        trace.gauge(name)


def _sanitize(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if not name or not (name[0].isalpha() or name[0] in "_:"):
        name = "_" + name
    return name


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_text(items, extra: str | None = None) -> str:
    parts = [f'{_sanitize(k)}="{_escape_label(v)}"' for k, v in items]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(value: float) -> str:
    # integers render bare (Prometheus accepts both; bare reads better
    # for counters), non-integers as repr floats
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


def _fmt_le(bound: float) -> str:
    return f"{bound:.6g}"


def _render_instruments(lines: list) -> None:
    for inst in trace.TRACER.instruments():
        name = _sanitize(f"ptpu_{inst.name}")
        if inst.kind == "counter":
            if not name.endswith("_total"):
                name += "_total"
            lines.append(f"# TYPE {name} counter")
            for items, value in inst.samples():
                lines.append(f"{name}{_labels_text(items)} {_fmt(value)}")
        elif inst.kind == "gauge":
            lines.append(f"# TYPE {name} gauge")
            for items, value in inst.samples():
                lines.append(f"{name}{_labels_text(items)} {_fmt(value)}")
        else:  # histogram
            lines.append(f"# TYPE {name} histogram")
            for items, s in inst.series():
                running = 0
                for bound, n in zip(inst.buckets, s["counts"]):
                    running += n
                    le = 'le="' + _fmt_le(bound) + '"'
                    lines.append(f"{name}_bucket"
                                 f"{_labels_text(items, le)} {running}")
                inf = 'le="+Inf"'
                lines.append(f"{name}_bucket{_labels_text(items, inf)} "
                             f"{s['count']}")
                lines.append(
                    f"{name}_sum{_labels_text(items)} {repr(s['sum'])}")
                lines.append(
                    f"{name}_count{_labels_text(items)} {s['count']}")


def render_prometheus(extra: dict | None = None) -> str:
    """The full exposition page; ``extra`` adds service-local gauges
    (queue depth, liveness) the tracer does not carry."""
    lines = []
    gauges = dict(trace.TRACER.metrics_latest())
    if extra:
        gauges.update(extra)
    counters = {}
    for name in sorted(gauges):
        metric = _sanitize(f"ptpu_{name}")
        if name in MONOTONIC_METRICS:
            total = metric if metric.endswith("_total") \
                else metric + "_total"
            counters[total] = gauges[name]
            if metric.endswith("_total"):
                continue  # migrated in place: counter only, no alias
            # deprecated gauge alias (one release) falls through
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {_fmt(gauges[name])}")
    for total in sorted(counters):
        lines.append(f"# TYPE {total} counter")
        lines.append(f"{total} {_fmt(counters[total])}")

    _render_instruments(lines)

    summary = trace.TRACER.summary()
    if summary:
        lines.append("# TYPE ptpu_span_total counter")
        for name in sorted(summary):
            lines.append(
                f'ptpu_span_total{{span="{_sanitize(name)}"}} '
                f'{summary[name]["count"]}')
        # deprecated alias of ptpu_span_total (one release)
        lines.append("# TYPE ptpu_span_count gauge")
        for name in sorted(summary):
            lines.append(
                f'ptpu_span_count{{span="{_sanitize(name)}"}} '
                f'{summary[name]["count"]}')
        lines.append("# TYPE ptpu_span_seconds_total counter")
        for name in sorted(summary):
            lines.append(
                f'ptpu_span_seconds_total{{span="{_sanitize(name)}"}} '
                f'{summary[name]["total_s"]:.6f}')
        lines.append("# TYPE ptpu_span_seconds_max gauge")
        for name in sorted(summary):
            lines.append(
                f'ptpu_span_seconds_max{{span="{_sanitize(name)}"}} '
                f'{summary[name]["max_s"]:.6f}')
    return "\n".join(lines) + "\n"


# --- exposition-format lint (pure python, no scraper needed) ---------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                         # optional label block
    r" (-?(?:[0-9.eE+-]+|Inf|NaN))$")        # value
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _family(name: str, types: dict) -> str | None:
    """The declared family a sample name belongs to (histogram samples
    use the base name's TYPE declaration)."""
    if name in types:
        return name
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in types:
            return name[: -len(suffix)]
    return None


def lint_exposition(text: str) -> list:
    """Validate a text-exposition page; returns a list of error strings
    (empty = clean). Checks: name/label grammar, float-parseable values,
    one TYPE per family declared before its samples, counter names
    ending in ``_total``, no duplicate series, and histogram internal
    consistency (cumulative buckets, ``+Inf`` == ``_count``, ``_sum``
    present)."""
    errors = []
    types: dict = {}
    seen: set = set()
    values: dict = {}  # (name, labelkey) -> float
    hist: dict = {}    # family -> labelkey(no le) -> [(le, count)]
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] == "TYPE":
                if len(parts) != 4 or parts[3] not in (
                        "counter", "gauge", "histogram", "summary",
                        "untyped"):
                    errors.append(f"line {lineno}: malformed TYPE line")
                    continue
                name = parts[2]
                if name in types:
                    errors.append(
                        f"line {lineno}: duplicate TYPE for {name}")
                if not _NAME_RE.match(name):
                    errors.append(
                        f"line {lineno}: bad metric name {name!r}")
                if parts[3] == "counter" and not name.endswith("_total"):
                    errors.append(
                        f"line {lineno}: counter {name} lacks _total "
                        "suffix")
                types[name] = parts[3]
            continue  # HELP/comments: free-form
        m = _SAMPLE_RE.match(line)
        if m is None:
            errors.append(f"line {lineno}: unparseable sample {line!r}")
            continue
        name, label_blob, value = m.groups()
        fvalue = None
        try:
            fvalue = float(value)
        except ValueError:
            errors.append(f"line {lineno}: bad value {value!r}")
        labels = []
        if label_blob:
            consumed = _LABEL_PAIR_RE.sub("", label_blob).strip(", ")
            if consumed:
                errors.append(
                    f"line {lineno}: bad label syntax {label_blob!r}")
            labels = _LABEL_PAIR_RE.findall(label_blob)
            for k, _ in labels:
                if not _LABEL_RE.match(k):
                    errors.append(f"line {lineno}: bad label name {k!r}")
        family = _family(name, types)
        if family is None:
            errors.append(f"line {lineno}: sample {name} has no "
                          "preceding TYPE declaration")
        series_key = (name, tuple(sorted(labels)))
        if series_key in seen:
            errors.append(f"line {lineno}: duplicate series "
                          f"{name}{dict(labels)}")
        seen.add(series_key)
        if fvalue is not None:
            values[series_key] = fvalue
        if family is not None and types[family] == "histogram" \
                and name.endswith("_bucket"):
            key = tuple(sorted((k, v) for k, v in labels if k != "le"))
            le = dict(labels).get("le")
            if le is None:
                errors.append(f"line {lineno}: _bucket without le label")
            elif fvalue is not None:  # a bad value was already reported
                hist.setdefault(family, {}).setdefault(
                    key, []).append((le, fvalue))
    # histogram consistency per label set
    for family, by_labels in hist.items():
        for key, buckets in by_labels.items():
            counts = [c for _, c in buckets]
            if counts != sorted(counts):
                errors.append(f"{family}{dict(key)}: bucket counts are "
                              "not cumulative")
            if buckets[-1][0] != "+Inf":
                errors.append(f"{family}{dict(key)}: last bucket is "
                              f"{buckets[-1][0]!r}, not +Inf")
            for suffix in ("_sum", "_count"):
                if (family + suffix, key) not in seen:
                    errors.append(
                        f"{family}{dict(key)}: missing {family}{suffix}")
            count = values.get((family + "_count", key))
            if buckets[-1][0] == "+Inf" and count is not None \
                    and buckets[-1][1] != count:
                errors.append(
                    f"{family}{dict(key)}: +Inf bucket "
                    f"{buckets[-1][1]} != _count {count}")
    return errors
