"""SLO burn-rate engine over the in-process instrument state.

Declares service-level objectives in the terms the convergence
analyses name as the levers that matter — score freshness, replication
lag, proof wall time by circuit size, read latency, error rate — and
evaluates each with the standard multi-window burn-rate method: a
*fast* window (is it burning NOW?) AND a *slow* window (has it burned
long enough to matter?) must both exceed budget before an alert trips.
Burn rate is ``(observed bad fraction) / (allowed bad fraction)``; 1.0
means burning error budget exactly at the sustainable rate, so the
alert gate is strictly ``> 1.0`` on BOTH windows — exactly-at-budget
does not page. An empty window (no traffic) is in budget: burn 0.0.

The engine samples cumulative (good, total) pairs from histogram /
gauge state into per-spec rings and differences them at the window
edges, so it needs no external store and restarts clean. Alerts latch:
once tripped, an SLO stays alerting (on ``/status`` and
``ptpu_slo_alert``) until BOTH windows are back within budget.

Negative sentinel discipline: gauge-kind SLOs receive their samples
through a fleet gauge view that already maps the ``-1`` pre-publish
sentinels to ``None`` — a ``None`` sample is "no data" and is not
counted into either good or total (see ``telemetry.fleet_gauge_view``).
"""

from __future__ import annotations

import threading
import time

from ..utils import trace

# one-sided slack when comparing a latency threshold against histogram
# bucket bounds, so a threshold equal to a bound counts that bucket
_BOUND_EPS = 1e-9


class SloSpec:
    """One declared objective.

    kind "latency": fraction of ``source`` histogram observations at
    or under ``threshold`` seconds must be >= ``objective``; optional
    ``label_filter`` (value or tuple of allowed values per key) and
    ``group_by`` (label keys that split the SLO into per-group burn
    rates, e.g. proof wall by ``k``).

    kind "ratio": fraction of ``source`` observations whose
    ``bad_label`` (key, value-prefix) does NOT match must be >=
    ``objective`` — e.g. HTTP non-5xx rate.

    kind "gauge": each engine tick samples one named gauge from the
    fleet view; the sample is good when <= ``threshold``. ``None``
    samples (no data / sentinel) are skipped entirely.
    """

    def __init__(self, name: str, kind: str, objective: float,
                 source: str = "", threshold: float = 0.0,
                 label_filter: dict | None = None,
                 group_by: tuple = (), bad_label: tuple | None = None,
                 description: str = ""):
        if kind not in ("latency", "ratio", "gauge"):
            raise ValueError(f"unknown SLO kind: {kind!r}")
        if not 0.0 < objective < 1.0:
            raise ValueError(f"objective must be in (0,1): {objective}")
        self.name = name
        self.kind = kind
        self.objective = float(objective)
        self.source = source
        self.threshold = float(threshold)
        self.label_filter = dict(label_filter or {})
        self.group_by = tuple(group_by)
        self.bad_label = bad_label
        self.description = description

    def _match(self, labels: dict) -> bool:
        for key, allowed in self.label_filter.items():
            value = labels.get(key)
            if isinstance(allowed, (tuple, list, set, frozenset)):
                if value not in allowed:
                    return False
            elif value != allowed:
                return False
        return True

    def counts(self, gauges: dict | None = None) -> dict:
        """Cumulative ``{group_key: (good, total)}`` right now."""
        out: dict = {}

        def _add(key, good, total):
            g0, t0 = out.get(key, (0.0, 0.0))
            out[key] = (g0 + good, t0 + total)

        if self.kind == "gauge":
            # cumulative-ized by the engine ring, one sample per tick
            value = (gauges or {}).get(self.source)
            if value is None:
                return {}
            good = 1.0 if float(value) <= self.threshold else 0.0
            return {(): (good, 1.0)}
        hist = trace.TRACER.histogram(self.source)
        bounds = hist.buckets
        for items, series in hist.series():
            labels = dict(items)
            if not self._match(labels):
                continue
            key = tuple(str(labels.get(k, "")) for k in self.group_by)
            total = float(series["count"])
            if self.kind == "ratio":
                lkey, prefix = self.bad_label
                bad = str(labels.get(lkey, "")).startswith(prefix)
                _add(key, 0.0 if bad else total, total)
            else:
                limit = self.threshold * (1.0 + _BOUND_EPS)
                good = float(sum(
                    n for bound, n in zip(bounds, series["counts"])
                    if bound <= limit))
                _add(key, good, total)
        return out


def default_slos() -> list:
    """The fleet's declared objectives."""
    return [
        SloSpec("score_freshness", "gauge", 0.95,
                source="score_freshness_seconds", threshold=60.0,
                description="fleet-max published-score age <= 60s"),
        SloSpec("repl_lag", "gauge", 0.95,
                source="repl_lag_seconds", threshold=30.0,
                description="fleet-max follower replication lag <= 30s"),
        SloSpec("proof_wall", "latency", 0.90,
                source="prover_total_seconds", threshold=120.0,
                group_by=("k",),
                description="proof wall time <= 120s, per circuit k"),
        SloSpec("read_p95", "latency", 0.95,
                source="http_request_seconds", threshold=0.25,
                label_filter={"endpoint": ("/scores", "/score/{addr}")},
                description="score read latency <= 250ms"),
        SloSpec("error_rate", "ratio", 0.999,
                source="http_request_seconds",
                bad_label=("status", "5"),
                description="HTTP non-5xx response rate"),
        # fed by the stall watchdog: the fleet-max heartbeat age of the
        # long-lived service threads. A stalled thread pages through
        # the SAME burn-rate path as every other objective — the
        # watchdog has no parallel alerting channel.
        SloSpec("thread_stall", "gauge", 0.95,
                source="thread_heartbeat_age_max_seconds",
                threshold=30.0,
                description="max service-thread heartbeat age <= 30s"),
    ]


class SloEngine:
    """Multi-window burn-rate evaluation with latched alerts."""

    def __init__(self, specs=None, fast_window: float = 60.0,
                 slow_window: float = 300.0):
        self.specs = list(default_slos() if specs is None else specs)
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self._lock = threading.Lock()
        # (spec name, group key) -> ring of (t, good_cum, total_cum)
        self._rings: dict = {}
        # spec name -> {"since": wall ts, "trips": n}
        self._alerts: dict = {}
        self._last_eval: list = []
        # spec names that latched during the most recent evaluate() —
        # the flight recorder's capture trigger (read right after
        # evaluate by the single observer/tick thread)
        self._new_alerts: list = []

    # --- sampling ----------------------------------------------------------

    def sample(self, gauges: dict | None = None,
               now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        horizon = now - self.slow_window * 2.0
        with self._lock:
            for spec in self.specs:
                counts = spec.counts(gauges=gauges)
                for group, (good, total) in counts.items():
                    ring = self._rings.setdefault((spec.name, group), [])
                    if spec.kind == "gauge":
                        # per-tick samples: accumulate into cumulative
                        g0, t0 = ring[-1][1:] if ring else (0.0, 0.0)
                        good, total = g0 + good, t0 + total
                    ring.append((now, good, total))
            for ring in self._rings.values():
                # keep one point at/before the horizon as the baseline
                while len(ring) > 2 and ring[1][0] <= horizon:
                    ring.pop(0)

    def _window_burn(self, ring, objective: float, window: float,
                     now: float):
        """Burn rate over the trailing ``window`` seconds; empty
        window (no traffic) is in budget → 0.0."""
        if not ring:
            return 0.0
        cutoff = now - window
        base = ring[0]
        for point in ring:
            if point[0] <= cutoff:
                base = point
            else:
                break
        end = ring[-1]
        total = end[2] - base[2]
        if total <= 0.0:
            return 0.0
        bad_frac = (total - (end[1] - base[1])) / total
        return bad_frac / (1.0 - objective)

    # --- evaluation --------------------------------------------------------

    def evaluate(self, now: float | None = None) -> list:
        now = time.monotonic() if now is None else now
        results = []
        new_alerts = []
        with self._lock:
            for spec in self.specs:
                groups = []
                alerting_now = False
                worst_fast = worst_slow = 0.0
                keys = sorted(k for k in self._rings
                              if k[0] == spec.name)
                for key in keys or [(spec.name, ())]:
                    ring = self._rings.get(key, [])
                    fast = self._window_burn(ring, spec.objective,
                                             self.fast_window, now)
                    slow = self._window_burn(ring, spec.objective,
                                             self.slow_window, now)
                    group = key[1]
                    groups.append({"group": group, "fast": fast,
                                   "slow": slow})
                    worst_fast = max(worst_fast, fast)
                    worst_slow = max(worst_slow, slow)
                    # the AND-gate: burning now AND burning long
                    # enough; strictly >1.0 so exactly-at-budget holds
                    if fast > 1.0 and slow > 1.0:
                        alerting_now = True
                latch = self._alerts.get(spec.name)
                if alerting_now and latch is None:
                    self._alerts[spec.name] = {
                        "since": time.time(),
                        "trips": 1,
                    }
                    new_alerts.append(spec.name)
                elif latch is not None:
                    # latched: release only once BOTH windows recover
                    if worst_fast <= 1.0 and worst_slow <= 1.0:
                        del self._alerts[spec.name]
                alerting = spec.name in self._alerts
                in_budget = worst_fast <= 1.0 and worst_slow <= 1.0
                results.append({
                    "slo": spec.name,
                    "kind": spec.kind,
                    "objective": spec.objective,
                    "description": spec.description,
                    "burn": {"fast": worst_fast, "slow": worst_slow},
                    "windows": {"fast_seconds": self.fast_window,
                                "slow_seconds": self.slow_window},
                    "groups": groups,
                    "in_budget": in_budget,
                    "alerting": alerting,
                    "alert_since":
                        self._alerts.get(spec.name, {}).get("since"),
                })
            self._last_eval = results
            self._new_alerts = new_alerts
        self._export(results)
        return results

    def new_alerts(self) -> list:
        """Spec names that latched during the most recent
        :meth:`evaluate` — the incident-capture trigger."""
        with self._lock:
            return list(self._new_alerts)

    def _export(self, results) -> None:
        burn = trace.gauge("slo_burn_rate")
        for r in results:
            name = r["slo"]
            spec = next(s for s in self.specs if s.name == name)
            for g in r["groups"]:
                extra = dict(zip(spec.group_by, g["group"]))
                burn.set(g["fast"], slo=name, window="fast", **extra)
                burn.set(g["slow"], slo=name, window="slow", **extra)
            trace.gauge("slo_in_budget").set(
                1.0 if r["in_budget"] else 0.0, slo=name)
            trace.gauge("slo_alert").set(
                1.0 if r["alerting"] else 0.0, slo=name)
            trace.gauge("slo_objective").set(r["objective"], slo=name)

    def status(self) -> dict:
        with self._lock:
            results = list(self._last_eval)
        alerts = [r["slo"] for r in results if r["alerting"]]
        return {
            "slos": results,
            "alerts": alerts,
            "alerting": bool(alerts),
        }
