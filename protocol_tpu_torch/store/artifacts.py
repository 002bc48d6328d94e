"""Persisted proof artifacts: proof history that survives the MRU.

The job queue's in-memory history is a bounded MRU — correct for RAM,
wrong for a service contract: a client that polls ``GET /proofs/<id>``
an hour later, or after a restart, deserves its proof. This store
mirrors the EigenFile assets discipline (fs.rs: one artifact, one
file, stable names) one directory per job::

    proofs/<job_id>/job.json             full job record (status, kind,
                                         params, result, timestamps)
    proofs/<job_id>/proof.bin            raw proof bytes (when the
                                         result carries a proof)
    proofs/<job_id>/public-inputs.bin    raw public inputs (ditto)

Every file is written tmp+rename; ``job.json`` is renamed LAST, so a
crash mid-persist leaves either nothing visible or a complete artifact
— ``load`` keys on ``job.json``. Job ids are validated against a strict
charset before touching the filesystem (they appear in URLs).
"""

from __future__ import annotations

import json
import os
import re
import time

from ..utils import trace

_SAFE_ID = re.compile(r"[A-Za-z0-9][A-Za-z0-9_.-]{0,128}$")
_JOB_NUM = re.compile(r"job-(\d+)$")


class ProofArtifactStore:
    """One directory per terminal job, committed by job.json rename."""

    def __init__(self, directory: str, faults=None):
        self.directory = directory
        self.faults = faults
        self.persist_failures = 0
        os.makedirs(directory, exist_ok=True)
        # counted once here, maintained incrementally: count() backs
        # /metrics and /healthz, which must not rescan the directory
        # (one stat per persisted job) on every scrape
        self._count = len(self.job_ids())

    def _dir(self, job_id: str) -> str | None:
        if not _SAFE_ID.match(job_id) or ".." in job_id:
            return None
        return os.path.join(self.directory, job_id)

    # --- write ------------------------------------------------------------
    def _write(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def persist(self, job) -> bool:
        """Persist a terminal job; returns False (and counts) on any
        failure, injected or real — losing one artifact must not kill
        the proof worker."""
        d = self._dir(job.job_id)
        if d is None:
            self.persist_failures += 1
            return False
        t0 = time.perf_counter()
        try:
            shape = (self.faults.disk_fault()
                     if self.faults is not None else None)
            os.makedirs(d, exist_ok=True)
            if shape is not None:
                if shape == "torn":
                    # the crash shape: a temp file load() must ignore
                    with open(os.path.join(d, "job.json.tmp"), "wb") as f:
                        f.write(b'{"torn":')
                self.persist_failures += 1
                return False
            result = job.result or {}
            if isinstance(result.get("proof"), str):
                try:
                    self._write(os.path.join(d, "proof.bin"),
                                bytes.fromhex(result["proof"]))
                except ValueError:
                    pass  # non-hex "proof" fields stay json-only
            if isinstance(result.get("public_inputs"), str):
                try:
                    self._write(os.path.join(d, "public-inputs.bin"),
                                bytes.fromhex(result["public_inputs"]))
                except ValueError:
                    pass
            fresh = not os.path.exists(os.path.join(d, "job.json"))
            self._write(os.path.join(d, "job.json"),
                        json.dumps(job.to_json()).encode())
            if fresh:
                self._count += 1
            trace.histogram("proof_persist_seconds").observe(
                time.perf_counter() - t0)
            return True
        except OSError:
            self.persist_failures += 1
            return False

    # --- read -------------------------------------------------------------
    def load(self, job_id: str) -> dict | None:
        """The persisted job record, or None (unknown/invalid/corrupt)."""
        d = self._dir(job_id)
        if d is None:
            return None
        try:
            with open(os.path.join(d, "job.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def proof_bytes(self, job_id: str) -> bytes | None:
        d = self._dir(job_id)
        if d is None:
            return None
        try:
            with open(os.path.join(d, "proof.bin"), "rb") as f:
                return f.read()
        except OSError:
            return None

    def job_ids(self) -> list:
        """Persisted job ids, oldest first (numeric ``job-N`` order,
        then lexicographic for foreign ids)."""
        try:
            names = [n for n in os.listdir(self.directory)
                     if os.path.exists(
                         os.path.join(self.directory, n, "job.json"))]
        except OSError:
            return []

        def order(name):
            m = _JOB_NUM.match(name)
            return (0, int(m.group(1)), name) if m else (1, 0, name)

        return sorted(names, key=order)

    def max_numeric_id(self) -> int:
        """Highest persisted ``job-N`` number (0 if none) — the queue's
        rehydration advances its id counter past it, and this module
        stays the single owner of the id grammar."""
        top = 0
        for name in self.job_ids():
            m = _JOB_NUM.match(name)
            if m:
                top = max(top, int(m.group(1)))
        return top

    def count(self) -> int:
        return self._count
