"""The proof pool's default registry and per-worker environment.

The reference's registry mints EigenTrust and Threshold proofs through
its device prover (``zk``), which the port does not carry yet: here the
``eigentrust`` and ``threshold`` kinds fail their job with an
``EigenError`` naming ROADMAP A6, and only the ``profile`` capture
window runs. Injected registries work as in the reference. The
per-worker environment pins each worker thread to its CUDA device.
"""

from __future__ import annotations

import contextlib

from ..utils import trace
from ..utils.errors import EigenError

# shedding tiers for the pool's graduated admission (pool.py): above
# the depth watermark the floor rises one tier per extra watermark of
# depth, so profile captures shed first, threshold proofs next, and
# eigentrust — the proof the service exists to mint — sheds only at
# the byte-budget ceiling. Unknown (test-injected) kinds default to 0.
PROOF_PRIORITIES = {"profile": 0, "threshold": 1, "eigentrust": 2}

# what the eigentrust/threshold kinds, sharded proves and the proving
# fabric need and the port does not have yet
UNPORTED = "the device prover (zk), which is not ported yet (ROADMAP A6)"


def refuse_unported(what: str):
    """Raise the one error every prover-backed surface gives until the
    zk stack is ported."""
    raise EigenError("config_error", f"{what} needs {UNPORTED}")


def make_worker_env(_service=None):
    """The pool's per-worker thread environment: the worker thread is
    pinned to its own CUDA device (``torch.cuda.device``; CUDA's current
    device is per thread). Host-path workers (no device, or a CPU one)
    get no pin. No prover cache is held: there is no device prover."""

    def env(worker):
        import torch

        dev = worker.device
        if dev is None or torch.device(dev).type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(dev)

    return env


def make_profile_prover(out_root) -> "callable":
    """The live-daemon capture window (``profile`` job kind): hold a
    ``torch.profiler`` capture (``trace.device_trace``) open for
    ``params["seconds"]`` while the daemon's other threads keep
    refreshing and serving — device activity in the window lands in
    the Chrome trace under ``log_dir``, and the
    capture's start/stop events carry the job id as trace id, so the
    timeline is joinable against the JSONL span stream. Runs on ONE
    pool worker, so it serializes with that worker's device proves
    (each device is a serially-owned resource) but NOT with the other
    workers, refreshes or HTTP — and the shedding tiers drop it first
    under load (PROOF_PRIORITIES). Trust model: the same as every
    other job kind — the API
    already hands its (operator-trusted, loopback-bound by default)
    clients minutes of device time per eigentrust/threshold prove, so
    a capture window adds no new starvation class; still, the window
    is clamped to 60 s per job and old capture dirs are pruned to the
    newest 8, so repeated captures bound disk instead of growing it."""
    import shutil
    import time as _time

    def _prune(profiles_root, keep: int = 8) -> None:
        try:
            entries = sorted((p.stat().st_mtime, p)
                             for p in profiles_root.iterdir()
                             if p.is_dir())
        except OSError:
            return
        for _, p in entries[:-keep]:
            shutil.rmtree(p, ignore_errors=True)

    def profile(params: dict) -> dict:
        try:
            seconds = float(params.get("seconds", 5.0))
        except (TypeError, ValueError) as e:
            raise EigenError("validation_error",
                             "profile jobs take {'seconds': float}") from e
        seconds = min(max(seconds, 0.1), 60.0)
        ids = trace.current_trace_ids()
        tag = ids[0] if ids else "adhoc"
        log_dir = str(out_root / "profiles" / tag)
        with trace.device_trace(log_dir):
            _time.sleep(seconds)
        _prune(out_root / "profiles")
        return {"log_dir": log_dir, "seconds": seconds,
                "xla": trace.compile_stats()}

    return profile


def make_provers(service, files) -> dict:
    """The default registry for :class:`pool.ProofWorkerPool`: the
    reference's three kinds. ``profile`` is the capture window; the
    ``eigentrust`` and ``threshold`` jobs fail with an ``EigenError``
    naming ROADMAP A6 until the prover is ported (injected registries
    work as in the reference)."""

    def unported(kind):
        def prove(params: dict) -> dict:
            refuse_unported(f"a {kind} proof job")

        return prove

    return {"eigentrust": unported("eigentrust"),
            "threshold": unported("threshold"),
            "profile": make_profile_prover(files.assets)}
