"""Cross-process proving fabric: the shard seam serialized over a
shared filesystem.

The port of ``protocol_tpu/zk/fabric.py``: the wire format, the
substrate and the executors are the reference's, so a frame, an
envelope or a result written by one package is read by the other byte
for byte. Its executors are host work on the port's C++ prover core
(``native/prover.py``; ``commit`` through ``g1_msm_multi``, which splits
a large MSM over row ranges on all cores — the same group element, so
the same result bytes). One repair: ``run_worker``'s per-unit lease
heartbeat thread no longer rebinds the ``beat`` callback, which made the
reference's loop raise on the pass after its first unit.

Intra-prove sharding (``zk/shards.py``) fans a prove's
independent work units out to idle pool workers — but a ``ShardUnit``
closes over live Python state (extension-domain arrays, the commit
engine's item list), so the seam stops at the process boundary: one
prove can never use more silicon than one Python process owns. This
module is the wire format + substrate that lifts that limit. A unit
becomes three durable artifacts under ``<state-dir>/fabric/``:

- ``units/<id>.json``  the ENVELOPE — ``(job id, stage, unit seq,
  executor kind, payload digest, shared-blob digests)`` committed
  tmp+rename (the artifact-store discipline: a crash mid-publish
  leaves nothing visible, never a torn envelope);
- ``blobs/<sha256>.bin``  CONTENT-ADDRESSED payload bytes — the framed
  arrays/scalars the closure used to capture, written once per digest
  (the SRS/Lagrange base limbs are shared by every commit unit of a
  prove, so they serialize once, not per unit);
- ``results/<id>.bin``  the RESULT record — framed bytes + CRC32 +
  the executing worker's name, tmp+rename. Execution is deterministic
  (every executor is bit-exact against the in-process closure), so a
  duplicate result — two workers racing one reclaimed unit — is
  byte-identical and ``os.replace`` makes the race harmless; a torn or
  corrupt result fails the CRC and reads as MISSING, never as data.

Leases make the fleet crash-safe without coordination: a worker claims
a unit by ``O_EXCL``-creating ``leases/<id>.json`` with a deadline and
heartbeats it forward; a SIGKILLed worker's heartbeat stops, the lease
lapses, and the submitting side (or another worker) reclaims the unit.
The rendezvous (``service/pool.py::_ShardRunner``) claims anything
unleased at join, so a dead fleet degrades to the serial in-process
order — never a hang. Byte-identical transcripts remain the hard
invariant: results merge at the rendezvous in submission order exactly
as the in-process runner merges them, and every executor below is
bit-exact against the closure it replaces (parity-tested against
direct ``prove_fast`` in ``tests/test_torch_fabric.py``).

Executors (``EXECUTORS``) are pure functions of the payload — no
params object, no proving key, no transcript state crosses the wire:

- ``quotient``   a row slice of the host quotient identity
  (``FieldKernel.quotient_eval`` is pointwise per evaluation row);
- ``open_fold``  one whole opening fold (γ-power fold + linear divide);
- ``commit``     a grouped commit chunk via ``g1_msm_multi`` over the
  shipped base limbs — the BLINDS stay on the submitting side
  (``CommitEngine._finish_group``), so the wire carries no secrets
  derived from the blinding stream beyond the scalar columns the
  in-process lent worker would see anyway.

``run_worker`` is the external worker loop (the ``prove-worker`` CLI
verb): poll → claim → execute → publish result, against either a local
:class:`FabricStore` (shared filesystem) or a :class:`RemoteFabric`
(the daemon's ``/fabric/*`` HTTP surface — the cross-box case).
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import json
import os
import re
import threading
import time
import zlib

import numpy as np

from ..utils import trace
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .bn254 import BN254_FQ_MODULUS

R = BN254_FR_MODULUS
Q = BN254_FQ_MODULUS

_MAGIC = b"PTF1"
_SAFE_ID = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]{0,160}$")

# test seam: seconds an external worker sleeps between CLAIMING a unit
# and executing it — gives the lease-expiry fault test a deterministic
# mid-unit window to SIGKILL the worker in
_STALL_ENV = "PTPU_FABRIC_TEST_STALL"


class FabricError(EigenError):
    """A fabric wire-format or substrate failure (bad frame, CRC
    mismatch, unknown executor). Publishers treat it as best-effort
    (fall back to in-process execution); workers skip the unit."""

    def __init__(self, message: str):
        super().__init__("read_write_error", message)


# --- framed codec -----------------------------------------------------------
# One frame = MAGIC + u32(header len) + header JSON + buffers + u32
# CRC32 over everything before it. Arrays are replaced in the walked
# object by {"__nd__": i, dtype, shape} markers; buffer i's length is
# recorded in the header so decode can slice without trusting offsets.


def _walk_out(obj, buffers: list):
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        buffers.append(arr.tobytes())
        return {"__nd__": len(buffers) - 1, "dtype": str(arr.dtype),
                "shape": list(arr.shape)}
    if isinstance(obj, dict):
        return {k: _walk_out(v, buffers) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_walk_out(v, buffers) for v in obj]
    return obj


def _walk_in(obj, buffers: list):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            raw = buffers[obj["__nd__"]]
            return np.frombuffer(raw, dtype=obj["dtype"]).reshape(
                obj["shape"]).copy()  # own the memory: executors
            # (balance_columns) mutate in place
        return {k: _walk_in(v, buffers) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_walk_in(v, buffers) for v in obj]
    return obj


def frame(obj, meta: dict | None = None) -> bytes:
    """Encode ``obj`` (nested dict/list of JSON scalars + numpy arrays)
    into one CRC-framed byte string. ``meta`` rides in the header."""
    buffers: list = []
    walked = _walk_out(obj, buffers)
    header = json.dumps({"obj": walked,
                         "lens": [len(b) for b in buffers],
                         "meta": meta or {}}).encode()
    body = b"".join((_MAGIC, len(header).to_bytes(4, "little"), header,
                     *buffers))
    return body + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "little")


def unframe(data: bytes) -> tuple:
    """Decode a frame; returns ``(obj, meta)``. Raises
    :class:`FabricError` on a short, torn, or corrupt frame — callers
    treat that as MISSING, never as data."""
    if len(data) < 12 or data[:4] != _MAGIC:
        raise FabricError("fabric frame: bad magic or truncated")
    crc = int.from_bytes(data[-4:], "little")
    if (zlib.crc32(data[:-4]) & 0xFFFFFFFF) != crc:
        raise FabricError("fabric frame: CRC mismatch (torn result)")
    hlen = int.from_bytes(data[4:8], "little")
    try:
        header = json.loads(data[8 : 8 + hlen])
    except ValueError as e:
        raise FabricError(f"fabric frame: bad header: {e}") from e
    buffers = []
    off = 8 + hlen
    for n in header.get("lens", ()):
        buffers.append(data[off : off + n])
        off += n
    if off != len(data) - 4:
        raise FabricError("fabric frame: buffer lengths disagree")
    return _walk_in(header["obj"], buffers), header.get("meta", {})


class Shared:
    """Marks a payload array as a SHARED blob: stored content-addressed
    on its own (``blobs/<sha256>``) and referenced by digest, so the
    base limb arrays every commit unit of a prove needs serialize once
    per prove (per content), not once per unit."""

    __slots__ = ("array",)

    def __init__(self, array: np.ndarray):
        self.array = np.ascontiguousarray(array)


class PortableUnit:
    """The serializable face of one :class:`~.shards.ShardUnit`:
    ``kind`` names the executor, ``build()`` materializes the payload
    (called once, at publish time — no cost when no external worker is
    registered), and ``apply(result)`` folds a remote result back into
    local state, returning what the in-process closure would have
    returned (the default is the executor's ``value`` field; the
    commit engine overrides it to set points + blinds on its items)."""

    __slots__ = ("kind", "build", "apply")

    def __init__(self, kind: str, build, apply=None):
        self.kind = kind
        self.build = build
        self.apply = apply if apply is not None \
            else (lambda res: res.get("value"))


# --- executors --------------------------------------------------------------


def _exec_quotient(p: dict) -> dict:
    from ..native import prover as native

    a = p["arrays"]
    s = p["scalars"]
    fk = native.FieldKernel(R)
    out = fk.quotient_eval(
        a["wires"], a["z"], a["zw"], a["m"], a["phi"], a["phiw"],
        a["uv"], a["fixed"], a["sigma"], a["pi"], a["xs"], a["zh_inv"],
        a["l0"], int(s["beta"]), int(s["gamma"]), int(s["beta_lk"]),
        int(s["alpha"]), [int(v) for v in s["shifts"]])
    return {"value": out}


def _exec_open_fold(p: dict) -> dict:
    from ..native import prover as native

    fk = native.FieldKernel(R)
    polys = p["polys"]
    at = int(p["at"])
    v_ch = int(p["v"])
    width = max(len(q) for q in polys)
    folded = np.zeros((width, 4), dtype="<u8")
    g = 1
    for q in polys:
        term = fk.scalar_mul(q, g)
        folded[: len(term)] = fk.vec_add(folded[: len(term)], term)
        g = g * v_ch % R
    return {"value": fk.poly_divide_linear(folded, at)}


def _exec_commit(p: dict) -> dict:
    from ..native import prover as native
    from .commit_engine import balance_columns

    bases = p["bases"]
    stack = np.ascontiguousarray(p["cols"])
    balanced, flips = balance_columns(stack)  # in place (owned copy)
    points = native.g1_msm_multi(Q, bases, balanced, flips)
    return {"points": [list(pt) if pt is not None else None
                       for pt in points]}


# kind -> fn(payload) -> result obj. Every executor is bit-exact
# against the in-process closure it replaces: quotient is pointwise
# per row, the fold is a whole unit, and g1_msm_multi is bit-exact per
# column under any grouping — so remote placement never moves a
# transcript byte.
EXECUTORS = {
    "quotient": _exec_quotient,
    "open_fold": _exec_open_fold,
    "commit": _exec_commit,
}


# --- the filesystem substrate -----------------------------------------------


class FabricStore:
    """The fabric directory: envelopes, content-addressed payload
    blobs, lease files and result records under one root. Every write
    is tmp+rename (the artifact-store commit discipline); blob reads
    re-verify the content digest and result reads re-verify the frame
    CRC, so torn bytes read as missing. One instance serves both sides
    — the daemon publishes and joins, ``prove-worker`` claims and
    executes — coordinating through nothing but the filesystem."""

    def __init__(self, root: str, lease_ttl: float = 5.0, faults=None):
        self.root = root
        self.lease_ttl = float(lease_ttl)
        self.faults = faults
        self.published = 0
        self.results_applied = 0
        self._seq = itertools.count(1)
        self._workers_cache = (0.0, 0)  # (checked_at, live count)
        for sub in ("units", "blobs", "results", "leases", "workers"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)

    # --- low-level write (tmp+rename + fault seam) ------------------------
    def _write(self, path: str, data: bytes) -> None:
        shape = self.faults.disk_fault() if self.faults is not None \
            else None
        if shape is not None:
            if shape == "torn":
                # the crash shape: partial bytes under the tmp name —
                # never visible to readers (they key on the final name)
                with open(path + ".tmp", "wb") as f:
                    f.write(data[: max(1, len(data) // 3)])
            raise FabricError(f"injected disk fault ({shape})")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def _path(self, sub: str, name: str) -> str:
        if not _SAFE_ID.match(name) or ".." in name:
            raise FabricError(f"unsafe fabric id {name!r}")
        return os.path.join(self.root, sub, name)

    # --- blobs ------------------------------------------------------------
    def put_blob(self, data: bytes) -> str:
        digest = hashlib.sha256(data).hexdigest()
        path = self._path("blobs", digest + ".bin")
        if not os.path.exists(path):  # content-addressed: write once
            self._write(path, data)
        return digest

    def get_blob(self, digest: str) -> bytes:
        path = self._path("blobs", digest + ".bin")
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise FabricError(f"missing fabric blob {digest}") from e
        if hashlib.sha256(data).hexdigest() != digest:
            raise FabricError(f"fabric blob {digest} corrupt")
        return data

    # --- publisher side ---------------------------------------------------
    def publish(self, job_id: str, unit) -> str:
        """Serialize one shard unit: payload blob(s) first, envelope
        last (tmp+rename), so a unit is either fully claimable or
        invisible. Sets ``unit.fabric_id`` and returns it."""
        portable = unit.portable
        if portable is None:
            raise FabricError("unit has no portable form")
        payload = portable.build()
        shared_digests = []

        def _lift(obj):
            if isinstance(obj, Shared):
                data = frame(obj.array)
                digest = self.put_blob(data)
                shared_digests.append(digest)
                return {"__shared__": digest}
            if isinstance(obj, dict):
                return {k: _lift(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return [_lift(v) for v in obj]
            return obj

        lifted = _lift(payload)
        payload_digest = self.put_blob(frame(lifted))
        fabric_id = f"{job_id}.{next(self._seq)}"
        envelope = {
            "unit": fabric_id,
            "job_id": job_id,
            "stage": unit.stage,
            "seq": unit.index,
            "kind": portable.kind,
            "payload": payload_digest,
            "shared": shared_digests,
            "created_at": time.time(),
        }
        self._write(self._path("units", fabric_id + ".json"),
                    json.dumps(envelope).encode())
        unit.fabric_id = fabric_id
        self.published += 1
        return fabric_id

    def try_result(self, fabric_id: str):
        """``(result obj, worker name, remote wall seconds)`` for a
        published unit, or None (absent, torn, or corrupt — the CRC
        makes them equivalent). The wall time is the WORKER's measured
        execution seconds carried in the frame meta (None for frames
        written by older workers) — the honest remote sample for
        ``ptpu_fabric_unit_seconds{source="remote"}``."""
        try:
            with open(self._path("results", fabric_id + ".bin"),
                      "rb") as f:
                data = f.read()
        except OSError:
            return None
        try:
            obj, meta = unframe(data)
        except FabricError:
            trace.event("fabric.result_corrupt", unit=fabric_id)
            return None
        self.results_applied += 1
        wall = meta.get("wall_s")
        return (obj, str(meta.get("worker") or "fabric"),
                float(wall) if wall is not None else None)

    def lease_state(self, fabric_id: str) -> str:
        """``live`` | ``expired`` | ``none`` for a unit's lease."""
        try:
            with open(self._path("leases", fabric_id + ".json")) as f:
                lease = json.load(f)
        except (OSError, ValueError):
            return "none"
        return "live" if float(lease.get("deadline", 0)) > time.time() \
            else "expired"

    def clear_lease(self, fabric_id: str) -> None:
        with contextlib.suppress(OSError, FabricError):
            os.unlink(self._path("leases", fabric_id + ".json"))

    def retire(self, fabric_id: str, blob_digests=()) -> None:
        """Best-effort cleanup after the rendezvous joined: envelope,
        lease, result, and the unit's payload blobs. Shared blobs may
        still be referenced by a concurrent prove — losing one only
        costs that prove its remote path (the rendezvous runs the unit
        locally), never correctness."""
        with contextlib.suppress(OSError, FabricError):
            os.unlink(self._path("units", fabric_id + ".json"))
        self.clear_lease(fabric_id)
        with contextlib.suppress(OSError, FabricError):
            os.unlink(self._path("results", fabric_id + ".bin"))
        for digest in blob_digests:
            with contextlib.suppress(OSError, FabricError):
                os.unlink(self._path("blobs", digest + ".bin"))

    # --- worker registry --------------------------------------------------
    def register_worker(self, name: str, ttl: float | None = None) -> None:
        ttl = self.lease_ttl if ttl is None else float(ttl)
        self._write(self._path("workers", name + ".json"),
                    json.dumps({"worker": name, "pid": os.getpid(),
                                "deadline": time.time() + ttl}).encode())

    def unregister_worker(self, name: str) -> None:
        with contextlib.suppress(OSError, FabricError):
            os.unlink(self._path("workers", name + ".json"))

    def workers_live(self) -> int:
        """Externally registered workers with an unexpired heartbeat.
        Cached briefly: the pool consults this per shardable job and
        per dispatch, and a listdir storm under the scheduler would be
        pure overhead."""
        checked_at, live = self._workers_cache
        now = time.time()
        if now - checked_at < 0.2:
            return live
        live = 0
        try:
            names = os.listdir(os.path.join(self.root, "workers"))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, "workers", name)) as f:
                    rec = json.load(f)
                if float(rec.get("deadline", 0)) > now:
                    live += 1
            except (OSError, ValueError):
                continue
        self._workers_cache = (now, live)
        return live

    def oldest_lease_age(self) -> float:
        """Age in seconds of the oldest live lease (0.0 when none) —
        the lease-age gauge's source."""
        oldest = 0.0
        now = time.time()
        try:
            names = os.listdir(os.path.join(self.root, "leases"))
        except OSError:
            return 0.0
        for name in names:
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, "leases", name)) as f:
                    lease = json.load(f)
            except (OSError, ValueError):
                continue
            if float(lease.get("deadline", 0)) > now:
                oldest = max(oldest,
                             now - float(lease.get("taken_at", now)))
        return oldest

    # --- worker side ------------------------------------------------------
    def list_units(self) -> list:
        """Unit envelopes without a visible result, oldest first."""
        try:
            names = sorted(os.listdir(os.path.join(self.root, "units")))
        except OSError:
            return []
        out = []
        for name in names:
            if not name.endswith(".json"):
                continue
            unit_id = name[: -len(".json")]
            if os.path.exists(
                    os.path.join(self.root, "results", unit_id + ".bin")):
                continue
            try:
                with open(os.path.join(self.root, "units", name)) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                continue
        return out

    def claim(self, fabric_id: str, worker: str,
              ttl: float | None = None) -> bool:
        """Take the unit's lease: ``O_EXCL`` create wins the fresh
        race; an EXPIRED lease is taken over via atomic replace (two
        takeover racers both run the unit — results are deterministic
        and idempotent, so the race costs compute, never bytes)."""
        ttl = self.lease_ttl if ttl is None else float(ttl)
        path = self._path("leases", fabric_id + ".json")
        record = json.dumps({"worker": worker, "taken_at": time.time(),
                             "deadline": time.time() + ttl}).encode()
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
        except FileExistsError:
            if self.lease_state(fabric_id) != "expired":
                return False
            try:  # takeover: atomic replace of the lapsed lease
                self._write(path, record)
            except (OSError, FabricError):
                return False
            return True
        except OSError:
            return False
        try:
            os.write(fd, record)
        finally:
            os.close(fd)
        return True

    def heartbeat(self, fabric_id: str, worker: str,
                  ttl: float | None = None) -> None:
        ttl = self.lease_ttl if ttl is None else float(ttl)
        with contextlib.suppress(OSError, FabricError):
            self._write(self._path("leases", fabric_id + ".json"),
                        json.dumps({
                            "worker": worker, "taken_at": time.time(),
                            "deadline": time.time() + ttl}).encode())

    def load_payload(self, envelope: dict):
        """The executor-ready payload object for an envelope: fetch the
        payload blob (digest-verified), unframe, resolve shared refs."""
        obj, _meta = unframe(self.get_blob(envelope["payload"]))

        def _resolve(o):
            if isinstance(o, dict):
                if "__shared__" in o:
                    arr, _m = unframe(self.get_blob(o["__shared__"]))
                    return arr
                return {k: _resolve(v) for k, v in o.items()}
            if isinstance(o, list):
                return [_resolve(v) for v in o]
            return o

        return _resolve(obj)

    def put_result(self, fabric_id: str, result, worker: str,
                   wall: float | None = None) -> None:
        """Frame + commit a unit's result (``wall``: the worker's
        measured execution seconds, carried in the frame meta).
        ``os.replace`` is atomic and execution is deterministic, so
        duplicate writers converge on identical bytes — idempotent by
        construction (wall jitter lives in meta, outside the result
        object the rendezvous consumes)."""
        meta = {"unit": fabric_id, "worker": worker}
        if wall is not None:
            meta["wall_s"] = round(float(wall), 6)
        self._write(self._path("results", fabric_id + ".bin"),
                    frame(result, meta=meta))

    def status(self) -> dict:
        try:
            pending = len([n for n in os.listdir(
                os.path.join(self.root, "units")) if n.endswith(".json")])
        except OSError:
            pending = 0
        return {
            "root": self.root,
            "workers_live": self.workers_live(),
            "units_pending": pending,
            "units_published": self.published,
            "results_applied": self.results_applied,
            "lease_ttl": self.lease_ttl,
        }


# --- the cross-box transport ------------------------------------------------


class RemoteFabric:
    """The worker-side fabric API over the daemon's ``/fabric/*`` HTTP
    surface — same methods :func:`run_worker` uses on a local
    :class:`FabricStore`, for the box that shares no filesystem."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.lease_ttl = 5.0

    def _get(self, path: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(self.base_url + path,
                                    timeout=self.timeout) as resp:
            return resp.read()

    def _post(self, path: str, body: bytes,
              content_type="application/json") -> dict:
        import urllib.request

        req = urllib.request.Request(
            self.base_url + path, data=body, method="POST",
            headers={"Content-Type": content_type})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            data = resp.read()
        try:
            return json.loads(data) if data else {}
        except ValueError:
            return {}

    def register_worker(self, name: str, ttl: float | None = None) -> None:
        self._post("/fabric/workers", json.dumps(
            {"worker": name, "ttl": ttl or self.lease_ttl}).encode())

    def unregister_worker(self, name: str) -> None:
        with contextlib.suppress(Exception):
            self._post("/fabric/workers", json.dumps(
                {"worker": name, "ttl": 0}).encode())

    def list_units(self) -> list:
        try:
            return json.loads(self._get("/fabric/units")).get("units", [])
        except Exception:  # noqa: BLE001 - a poll is always retryable
            return []

    def claim(self, fabric_id: str, worker: str,
              ttl: float | None = None) -> bool:
        try:
            out = self._post("/fabric/claims", json.dumps(
                {"unit": fabric_id, "worker": worker,
                 "ttl": ttl or self.lease_ttl}).encode())
        except Exception:  # noqa: BLE001
            return False
        return bool(out.get("granted"))

    def heartbeat(self, fabric_id: str, worker: str,
                  ttl: float | None = None) -> None:
        with contextlib.suppress(Exception):
            self._post("/fabric/claims", json.dumps(
                {"unit": fabric_id, "worker": worker,
                 "ttl": ttl or self.lease_ttl,
                 "renew": True}).encode())

    def load_payload(self, envelope: dict):
        obj, _meta = unframe(self._get(
            "/fabric/blob/" + envelope["payload"]))

        def _resolve(o):
            if isinstance(o, dict):
                if "__shared__" in o:
                    arr, _m = unframe(self._get(
                        "/fabric/blob/" + o["__shared__"]))
                    return arr
                return {k: _resolve(v) for k, v in o.items()}
            if isinstance(o, list):
                return [_resolve(v) for v in o]
            return o

        return _resolve(obj)

    def put_result(self, fabric_id: str, result, worker: str,
                   wall: float | None = None) -> None:
        meta = {"unit": fabric_id, "worker": worker}
        if wall is not None:
            meta["wall_s"] = round(float(wall), 6)
        self._post(f"/fabric/results/{fabric_id}",
                   frame(result, meta=meta),
                   content_type="application/octet-stream")


# --- the external worker loop -----------------------------------------------


def execute_unit(envelope: dict, payload) -> dict:
    """Run one unit's executor; raises :class:`FabricError` for an
    unknown kind (a newer daemon's unit against an older worker —
    skipped, the rendezvous runs it locally)."""
    fn = EXECUTORS.get(envelope.get("kind"))
    if fn is None:
        raise FabricError(
            f"unknown fabric executor {envelope.get('kind')!r}")
    return fn(payload)


def run_worker(fabric, name: str, poll: float = 0.05,
               lease_ttl: float | None = None,
               max_units: int | None = None,
               idle_exit: float | None = None,
               stop=None, beat=None) -> int:
    """The ``prove-worker`` loop: register, poll for claimable units,
    lease + heartbeat + execute + publish, until ``stop`` is set,
    ``max_units`` have run, or the fabric stays idle past
    ``idle_exit`` seconds. Returns the number of units executed.

    The per-unit heartbeat thread keeps the lease alive across a long
    MSM; a SIGKILL anywhere in the loop simply stops the heartbeats —
    the lease lapses and the unit is reclaimed. The executing thread
    runs under ``worker_isolation`` so DeviceProver-cache state (if a
    future executor needs device work) stays private to this process."""
    from . import prover_fast as pf

    stall = float(os.environ.get(_STALL_ENV, "0") or 0)
    executed = 0
    last_work = time.monotonic()
    reg_ttl = max(2.0, (lease_ttl or 5.0) * 2)
    with contextlib.suppress(Exception):
        fabric.register_worker(name, ttl=reg_ttl)
    try:
        with pf.worker_isolation(name), trace.worker_context(name):
            while True:
                if beat is not None:
                    # stall-watchdog heartbeat: a wedged claim/execute
                    # (native MSM that never returns) ages this out
                    beat()
                if stop is not None and stop.is_set():
                    break
                if max_units is not None and executed >= max_units:
                    break
                if idle_exit is not None and \
                        time.monotonic() - last_work > idle_exit:
                    break
                with contextlib.suppress(Exception):
                    # a failed heartbeat (injected disk fault, transient
                    # HTTP error) just ages the registration — the next
                    # pass renews it
                    fabric.register_worker(name, ttl=reg_ttl)
                progressed = False
                for envelope in fabric.list_units():
                    unit_id = envelope.get("unit")
                    if not unit_id:
                        continue
                    if not fabric.claim(unit_id, name, ttl=lease_ttl):
                        continue
                    if stall > 0:
                        time.sleep(stall)  # test seam: SIGKILL window
                    done = threading.Event()

                    def _beat(uid=unit_id, ev=done):
                        ttl = lease_ttl or getattr(
                            fabric, "lease_ttl", 5.0)
                        while not ev.wait(max(0.2, ttl / 3.0)):
                            fabric.heartbeat(uid, name, ttl=ttl)

                    # its own name: ``beat`` is the caller's watchdog
                    # callback, called again on the next pass
                    lease_beat = threading.Thread(
                        target=_beat, daemon=True,
                        name=f"fabric-beat-{name}")
                    lease_beat.start()
                    try:
                        # the unit's span joins the submitting job's
                        # trace (job_id IS the proof job / trace id),
                        # so a shipped worker span window chains into
                        # the leader's tailer→pool→prove.shard view
                        job_id = envelope.get("job_id") or None
                        t0 = time.perf_counter()
                        with trace.context(trace_id=job_id):
                            payload = fabric.load_payload(envelope)
                            with trace.span("fabric.unit",
                                            stage=envelope.get("stage",
                                                               ""),
                                            unit=unit_id, remote=1):
                                result = execute_unit(envelope, payload)
                        # carry the measured wall back in the result
                        # frame meta: the leader's pool observes it as
                        # the honest source="remote" fabric sample
                        fabric.put_result(
                            unit_id, result, name,
                            wall=time.perf_counter() - t0)
                        executed += 1
                        progressed = True
                        last_work = time.monotonic()
                    except (FabricError, Exception) as e:  # noqa: BLE001
                        # a failed unit is NOT fatal to the fleet: the
                        # lease lapses (or is cleared) and the
                        # rendezvous runs the unit in-process
                        trace.event("fabric.unit_failed", unit=unit_id,
                                    error=str(e))
                    finally:
                        done.set()
                        lease_beat.join(timeout=2.0)
                    if max_units is not None and executed >= max_units:
                        break
                if not progressed:
                    time.sleep(poll)
    finally:
        with contextlib.suppress(Exception):
            fabric.unregister_worker(name)
    return executed
