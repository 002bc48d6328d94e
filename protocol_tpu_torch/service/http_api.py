"""HTTP API for the trust-scores service (stdlib ``http.server``).

Same dependency posture as the mock devnet (``client/mocknode.py``): a
``ThreadingHTTPServer`` with a closure-bound handler, no framework.

Routes:

- ``GET /healthz``        liveness + cursor/peer/queue/store gauges
- ``GET /status``         operator JSON: uptime, cursor, graph size,
  score freshness, queue depths, last refresh stats, store summary
- ``GET /scores``         the full published score table (JSON)
- ``GET /score/<addr>``   one peer's score (404 before first sighting)
- ``POST /proofs``        submit a proof job ``{"kind", "params"}`` →
  202 + job id; 429 + ``Retry-After`` when the pool's tiered admission
  sheds this kind (depth past the watermark — lower-priority kinds go
  first); 503 at the byte-budget ceiling or while draining
- ``GET /proofs/<id>``    job status/result (falls back to the persisted
  artifact store past the in-memory MRU / across restarts)
- ``GET /proofs/<id>/proof.bin``  the raw proof bytes
  (application/octet-stream) — byte-identical to the batch prover's
  artifact file, served from the proof artifact store
- ``GET /stages``         per-stage duration summary (count, total,
  max, p50, p95 per span name — ``trace.stage_summary()``): the live
  twin of the ``obs`` verb's offline stream summary, covering prover
  stages and converge sweeps once work has flowed through them
- ``GET /metrics``        Prometheus text (``service/metrics.py``)
- ``GET /bundle``         the signed score bundle (``bundle.py``) with
  a strong ETag — verification-friendly, CDN/edge-cacheable; followers
  serve the leader's bundle verbatim
- ``GET /repl/wal``       leader only: committed WAL frames past
  ``?from=seg:off`` (the shipping transport — on-disk framing
  verbatim); ``X-Ptpu-Wal-Next``/``-Eof``/``-Gap``/``-Backlog`` headers
  carry the cursor protocol
- ``GET /repl/snapshot``  leader only: the newest snapshot payload
  (npz) + its meta in headers — follower bootstrap
- ``GET /fabric/units`` / ``GET /fabric/blob/<digest>`` /
  ``POST /fabric/claims`` / ``POST /fabric/results/<id>`` /
  ``POST /fabric/workers``  the cross-box face of the proving fabric
  (``serve --fabric``): remote ``prove-worker`` processes poll
  claimable units, fetch content-addressed payloads, lease/heartbeat,
  and upload CRC-framed results (``zk/fabric.py::RemoteFabric``)
- ``POST /telemetry``      leader only: a non-leader process ships its
  instrument snapshot + recent span window (``service/telemetry.py``)
- ``GET /fleet``          leader only: aggregated operator JSON — one
  staleness-honest row per known instance (dead rows stay, flagged)
- ``GET /fleet/metrics``  leader only: the federated Prometheus page —
  local + reported instrument state with ``instance``/``role`` labels
- ``GET /slo``            the SLO burn-rate engine's current
  evaluation (burn per window, in-budget flags, latched alerts)
- ``GET /incidents``      index of captured incident bundles (id,
  trigger, reason, captured_at) — newest last
- ``GET /incidents/<id>`` one full autopsy bundle as JSON (meta,
  frozen flight-recorder ring, thread stacks, SLO window state,
  metrics snapshot, plan costs) — the ``incident`` CLI verb renders it
- ``POST /incidents/capture``  operator-forced capture (bypasses the
  rate limit) → 201 + the new bundle id
- ``POST /debug/fail``    always answers 500 — present ONLY with
  ``debug_faults=1`` (smoke/test), to force an error-rate SLO burn

``/scores`` and ``/score/<addr>`` carry a strong revision-derived ETag
and honor ``If-None-Match`` (304, headers only) on leader and follower
alike. On a follower replica ``service.jobs`` is None: ``POST /proofs``
answers 503 read-only and ``GET /proofs/*`` 404s to the leader.

Middleware (every request): a per-request trace id (``X-Request-Id``
response header, ``trace_id`` on the request span in the JSONL stream)
and a ``ptpu_http_request_seconds`` latency histogram labeled by route
template + status — route templates, not raw paths, so the label
cardinality is the route table's, not the address space's.

GETs are lock-free against the hot path: the score table is an
immutable object swapped by the refresher, so a read races at worst
into the previous table, never a torn one.
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..utils import trace
from ..utils.errors import EigenError
from .jobs import QueueFullError
from .metrics import render_prometheus


def _parse_address(text: str) -> bytes | None:
    try:
        raw = bytes.fromhex(text.removeprefix("0x"))
    except ValueError:
        return None
    return raw if len(raw) == 20 else None


def _route_template(method: str, path: str) -> str:
    """Stable-cardinality route label: the template, never the raw
    path (addresses and job ids would explode the label space)."""
    if path in ("/healthz", "/status", "/scores", "/metrics", "/stages",
                "/bundle", "/repl/wal", "/repl/snapshot",
                "/fabric/units", "/fabric/claims", "/fabric/workers",
                "/telemetry", "/fleet", "/fleet/metrics", "/slo",
                "/incidents", "/incidents/capture", "/debug/fail"):
        return path
    if path.startswith("/incidents/"):
        return "/incidents/{id}"
    if path.startswith("/fabric/blob/"):
        return "/fabric/blob/{digest}"
    if path.startswith("/fabric/results/"):
        return "/fabric/results/{id}"
    if path.startswith("/score/"):
        return "/score/{addr}"
    if path.startswith("/proofs/") and path.endswith("/proof.bin"):
        return "/proofs/{id}/proof.bin"
    if path.startswith("/proofs/"):
        return "/proofs/{id}"
    if path == "/proofs" and method == "POST":
        return "/proofs"
    return "other"


def make_server(service, host: str, port: int) -> ThreadingHTTPServer:
    """Bind (not start) the API server for ``service``; ``port=0``
    picks an ephemeral port (``server_address[1]`` has the real one)."""

    class Handler(BaseHTTPRequestHandler):
        _status = 0
        _request_id = None

        def _reply(self, status: int, obj, content_type="application/json",
                   headers=None):
            if isinstance(obj, bytes):
                body = obj
            elif content_type == "application/json":
                body = json.dumps(obj).encode()
            else:
                body = obj.encode()
            self._status = status
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            if self._request_id:
                self.send_header("X-Request-Id", self._request_id)
            for key, value in (headers or {}).items():
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(body)

        def _not_modified(self, etag: str) -> None:
            """304 for a matched conditional GET: headers only, no
            body — the cheap read-path win ETags buy."""
            self._status = 304
            self.send_response(304)
            self.send_header("ETag", etag)
            if self._request_id:
                self.send_header("X-Request-Id", self._request_id)
            self.end_headers()

        def _etag_match(self, etag: str) -> bool:
            got = self.headers.get("If-None-Match")
            if not got:
                return False
            return etag in [v.strip() for v in got.split(",")] \
                or got.strip() == "*"

        def _instrumented(self, method: str, handler) -> None:
            """Per-request middleware: assign the request id, bind it as
            the trace context, time the handler, record the
            route/status latency histogram."""
            parts = self.path.split("?", 1)
            path = parts[0].rstrip("/") or "/"
            self._query = parse_qs(parts[1]) if len(parts) > 1 else {}
            route = _route_template(method, path)
            self._request_id = f"req-{trace.new_id()}"
            t0 = time.perf_counter()
            try:
                with trace.context(trace_id=self._request_id):
                    with trace.span("service.http", method=method,
                                    route=route):
                        handler(path)
            finally:
                trace.histogram("http_request_seconds").observe(
                    time.perf_counter() - t0, endpoint=route,
                    status=str(self._status or 500))

        # --- GET ----------------------------------------------------------
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            self._instrumented("GET", self._handle_get)

        def _handle_get(self, path: str):
            if path == "/healthz":
                return self._reply(200, service.health())
            if path == "/status":
                return self._reply(200, service.status())
            if path == "/stages":
                return self._reply(200, {
                    "stages": trace.stage_summary(),
                    "xla": trace.compile_stats(),
                })
            if path == "/metrics":
                return self._reply(
                    200, render_prometheus(service.extra_metrics()),
                    content_type="text/plain; version=0.0.4")
            if path == "/fleet/metrics":
                # federated scrape: local + every reported instance's
                # instrument state, instance/role-labelled (leader only
                # — followers and workers report INTO the leader)
                render = getattr(service, "fleet_metrics", None)
                if render is None:
                    return self._reply(
                        404, {"error": "no fleet registry here — "
                                       "scrape the leader"})
                return self._reply(
                    200, render(),
                    content_type="text/plain; version=0.0.4")
            if path == "/fleet":
                fleet = getattr(service, "fleet_status", None)
                if fleet is None:
                    return self._reply(
                        404, {"error": "no fleet registry here — "
                                       "ask the leader"})
                return self._reply(200, fleet())
            if path == "/slo":
                slo = getattr(service, "slo_status", None)
                if slo is None:
                    return self._reply(
                        404, {"error": "no SLO engine on this process"})
                return self._reply(200, slo())
            if path == "/incidents":
                index = getattr(service, "incident_index", None)
                if index is None:
                    return self._reply(
                        404, {"error": "no incident store on this "
                                       "process (needs a state dir)"})
                return self._reply(200, {"incidents": index()})
            if path.startswith("/incidents/"):
                load = getattr(service, "incident_bundle", None)
                if load is None:
                    return self._reply(
                        404, {"error": "no incident store on this "
                                       "process (needs a state dir)"})
                bundle = load(path[len("/incidents/"):])
                if bundle is None:
                    return self._reply(
                        404, {"error": "unknown incident id"})
                return self._reply(200, bundle)
            if path == "/scores":
                table = service.refresher.table
                # revision-derived strong ETag: a conditional scrape of
                # an unchanged table costs headers, not an O(peers)
                # JSON encode — on leader AND follower alike
                etag = table.etag
                if self._etag_match(etag):
                    return self._not_modified(etag)
                return self._reply(200, {
                    "revision": table.revision,
                    "computed_at": table.computed_at,
                    "iterations": table.iterations,
                    "delta": table.delta,
                    "cold": table.cold,
                    "scores": [
                        {"address": "0x" + a.hex(), "score": float(s)}
                        for a, s in zip(table.addresses, table.scores)
                    ],
                }, headers={"ETag": etag})
            if path.startswith("/score/"):
                addr = _parse_address(path[len("/score/"):])
                if addr is None:
                    return self._reply(
                        400, {"error": "address must be 20 hex bytes"})
                table = service.refresher.table
                etag = table.etag
                if self._etag_match(etag):
                    return self._not_modified(etag)
                score = table.score_of(addr)
                if score is None:
                    return self._reply(
                        404, {"error": "unknown peer",
                              "address": "0x" + addr.hex()})
                return self._reply(200, {
                    "address": "0x" + addr.hex(),
                    "score": score,
                    "revision": table.revision,
                }, headers={"ETag": etag})
            if path == "/bundle":
                got = service.bundle_response()
                if got is None:
                    return self._reply(
                        404, {"error": "no signed score bundle yet "
                                       "(nothing published)"})
                body, etag = got
                if etag and self._etag_match(etag):
                    return self._not_modified(etag)
                headers = {"Cache-Control": "public, max-age=1"}
                if etag:
                    headers["ETag"] = etag
                return self._reply(200, body, headers=headers)
            if path == "/repl/wal":
                src = getattr(service, "repl_source", None)
                if src is None:
                    return self._reply(
                        404, {"error": "not a replication leader "
                                       "(no state dir or follower "
                                       "mode)"})
                from .replication import format_position, parse_position

                try:
                    start = parse_position(
                        (self._query.get("from") or ["0:0"])[0])
                    max_bytes = int(
                        (self._query.get("max") or ["1048576"])[0])
                except (EigenError, ValueError) as e:
                    return self._reply(400, {"error": str(e)})
                follower = (self._query.get("follower") or [None])[0]
                out = src.wal_chunk(start,
                                    max_bytes=max(4096, max_bytes),
                                    follower=follower)
                return self._reply(
                    200, out["data"],
                    content_type="application/octet-stream",
                    headers={
                        "X-Ptpu-Wal-Next": format_position(out["next"]),
                        "X-Ptpu-Repl-Eof": "1" if out["eof"] else "0",
                        "X-Ptpu-Repl-Gap": "1" if out["gap"] else "0",
                        "X-Ptpu-Repl-Records": str(out["records"]),
                        "X-Ptpu-Repl-Backlog": str(out["backlog"]),
                    })
            if path == "/repl/snapshot":
                src = getattr(service, "repl_source", None)
                if src is None:
                    return self._reply(
                        404, {"error": "not a replication leader"})
                got = src.snapshot_blob()
                if got is None:
                    return self._reply(
                        404, {"error": "no snapshot yet — tail the "
                                       "WAL from 0:0"})
                step, meta, blob = got
                return self._reply(
                    200, blob,
                    content_type="application/octet-stream",
                    headers={
                        "X-Ptpu-Snapshot-Step": str(step),
                        "X-Ptpu-Snapshot-Meta": json.dumps(meta),
                    })
            if path == "/fabric/units" or path.startswith("/fabric/blob/"):
                # the cross-box face of the proving fabric: remote
                # prove-workers poll the claimable units and fetch
                # payload blobs by content digest (zk/fabric.py
                # RemoteFabric is the client)
                fabric = getattr(service, "fabric", None)
                if fabric is None:
                    return self._reply(
                        404, {"error": "proving fabric disabled "
                                       "(serve --fabric + a state dir)"})
                if path == "/fabric/units":
                    return self._reply(200,
                                       {"units": fabric.list_units()})
                digest = path[len("/fabric/blob/"):]
                try:
                    data = fabric.get_blob(digest)
                except EigenError:
                    return self._reply(404, {"error": "unknown blob"})
                return self._reply(200, data,
                                   content_type="application/octet-stream")
            if path.startswith("/proofs/") and path.endswith("/proof.bin"):
                job_id = path[len("/proofs/"):-len("/proof.bin")]
                data = service.proof_bytes(job_id)
                if data is None:
                    return self._reply(
                        404, {"error": "no proof artifact for this job"})
                return self._reply(200, data,
                                   content_type="application/octet-stream")
            if path.startswith("/proofs/"):
                if service.jobs is None:  # read-only follower
                    return self._reply(
                        404, {"error": "no proof queue on a follower "
                                       "replica — ask the leader"})
                job = service.jobs.get(path[len("/proofs/"):])
                if job is None:
                    return self._reply(404, {"error": "unknown job"})
                return self._reply(200, job.to_json())
            return self._reply(404, {"error": f"no route {path}"})

        # --- POST ---------------------------------------------------------
        def do_POST(self):  # noqa: N802
            self._instrumented("POST", self._handle_post)

        def _handle_post(self, path: str):
            if path in ("/fabric/claims", "/fabric/workers") \
                    or path.startswith("/fabric/results/"):
                return self._handle_fabric_post(path)
            if path == "/incidents/capture":
                capture = getattr(service, "incident_capture", None)
                if capture is None:
                    return self._reply(
                        404, {"error": "no incident store on this "
                                       "process (needs a state dir)"})
                inc_id = capture("operator", "POST /incidents/capture")
                if inc_id is None:
                    return self._reply(
                        500, {"error": "incident capture failed "
                                       "(see ptpu_incidents_capture_"
                                       "errors_total)"})
                return self._reply(201, {"id": inc_id})
            if path == "/debug/fail":
                # smoke/test-only fault injection: burns the
                # error_rate SLO through the real request path. Absent
                # (404) unless explicitly enabled.
                cfg = getattr(service, "config", None)
                if not getattr(cfg, "debug_faults", 0):
                    return self._reply(404, {"error": f"no route {path}"})
                return self._reply(500, {"error": "injected debug fault"})
            if path == "/telemetry":
                report = getattr(service, "telemetry_report", None)
                if report is None:
                    return self._reply(
                        404, {"error": "no telemetry registry here — "
                                       "report to the leader"})
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    obj = json.loads(self.rfile.read(length) or b"{}")
                    return self._reply(200, report(obj))
                except (ValueError, KeyError) as e:
                    return self._reply(
                        400, {"error": f"bad telemetry report: {e}"})
                except EigenError as e:
                    return self._reply(400, {"error": str(e)})
            if path != "/proofs":
                return self._reply(404, {"error": f"no route {path}"})
            if service.jobs is None:
                # follower replica: the read path scaled out, the
                # write/prove path did not — clients go to the leader
                return self._reply(
                    503, {"error": "read-only follower replica: "
                                   "submit proofs to the leader"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                kind = req["kind"]
                params = req.get("params", {})
                if not isinstance(params, dict):
                    raise ValueError("params must be an object")
            except (ValueError, KeyError) as e:
                return self._reply(
                    400, {"error": f"bad request body: {e}; expected "
                                   '{"kind": ..., "params": {...}}'})
            try:
                job = service.jobs.submit(kind, params)
            except QueueFullError as e:
                # tiered shed: this kind is below the admission floor
                # right now; Retry-After carries the pool's backlog
                # estimate so well-behaved clients pace themselves
                retry = getattr(e, "retry_after", None)
                headers = ({"Retry-After": str(int(retry))}
                           if retry else None)
                body = {"error": str(e)}
                if retry:
                    body["retry_after_seconds"] = int(retry)
                return self._reply(429, body, headers=headers)
            except EigenError as e:
                # over_capacity = the byte-budget ceiling: the pool is
                # protecting memory, not prioritizing — hard 503 like
                # a draining service
                status = (503 if e.kind in ("service_busy",
                                            "over_capacity") else 400)
                return self._reply(status, {"error": str(e)})
            return self._reply(202, job.to_json())

        def _handle_fabric_post(self, path: str):
            """Worker-side fabric writes over HTTP: lease claims and
            heartbeats (``/fabric/claims``), registration heartbeats
            (``/fabric/workers``, ttl 0 unregisters) and framed result
            uploads (``/fabric/results/{id}`` — raw octet-stream, the
            store re-verifies the frame CRC at the rendezvous so a
            truncated upload reads as missing, never as data)."""
            fabric = getattr(service, "fabric", None)
            if fabric is None:
                return self._reply(
                    404, {"error": "proving fabric disabled "
                                   "(serve --fabric + a state dir)"})
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            try:
                if path.startswith("/fabric/results/"):
                    unit_id = path[len("/fabric/results/"):]
                    # commit the pre-framed bytes verbatim: re-framing
                    # would launder a torn upload into a valid CRC
                    fabric._write(
                        fabric._path("results", unit_id + ".bin"), body)
                    return self._reply(200, {"ok": True})
                req = json.loads(body or b"{}")
                if not isinstance(req, dict) or "worker" not in req:
                    raise ValueError("body must carry worker")
                worker = str(req["worker"])
                ttl = float(req.get("ttl") or fabric.lease_ttl)
                if path == "/fabric/workers":
                    if ttl <= 0:
                        fabric.unregister_worker(worker)
                    else:
                        fabric.register_worker(worker, ttl=ttl)
                    return self._reply(200, {"ok": True})
                unit_id = str(req.get("unit") or "")
                if req.get("renew"):
                    fabric.heartbeat(unit_id, worker, ttl=ttl)
                    return self._reply(200, {"ok": True})
                granted = fabric.claim(unit_id, worker, ttl=ttl)
                return self._reply(200, {"granted": bool(granted)})
            except (ValueError, KeyError) as e:
                return self._reply(400, {"error": f"bad fabric "
                                                  f"request: {e}"})
            except EigenError as e:
                return self._reply(400, {"error": str(e)})

        def log_message(self, *a):  # quiet (the tracer is the log)
            pass

    return ThreadingHTTPServer((host, port), Handler)
