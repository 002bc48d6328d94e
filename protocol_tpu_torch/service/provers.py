"""The proof pool's default registry and per-worker environment.

The port of ``protocol_tpu/service/provers.py``. The ``eigentrust`` kind
mints the EigenTrust proof through ``zk.api.generate_et_proof`` over the
live attestation set, as the reference does: rounds 3–4 on the worker's
card (its ``DeviceProver``), the rest on the host. Artifact BYTES are
loaded once (``ArtifactCache``) and the same objects go to ``zk.api`` on
every job: its parse cache and the DeviceProver caches behind it key on
byte-object identity, so a second job is a warm prove. The
``threshold`` kind mints the Threshold proof through
``zk.api.generate_th_proof``, both of its proves (the inner EigenTrust
snark and the Threshold circuit) on the job's device; ``profile`` is the
capture window. Injected registries work as in the reference. The
per-worker environment gives each worker thread a private DeviceProver
cache pinned to its own CUDA device (``prover_fast.worker_isolation``).
"""

from __future__ import annotations

import threading

from ..utils import trace
from ..utils.errors import EigenError

# shedding tiers for the pool's graduated admission (pool.py): above
# the depth watermark the floor rises one tier per extra watermark of
# depth, so profile captures shed first, threshold proofs next, and
# eigentrust — the proof the service exists to mint — sheds only at
# the byte-budget ceiling. Unknown (test-injected) kinds default to 0.
PROOF_PRIORITIES = {"profile": 0, "threshold": 1, "eigentrust": 2}

# kinds that never shard under config.shard_proves: the profile
# capture window holds a device trace open, not prove stages — there
# is nothing to fan out, and lending workers into a capture window
# would only pollute its timeline. Every real prove kind (and any
# injected registry kind) is shardable; the prove paths degrade to
# fully-inline execution when no idle worker lends a hand, so
# shardability is an opportunity, never a requirement.
PROOF_SHARD_EXEMPT = frozenset({"profile"})


def make_worker_env(_service=None):
    """The pool's per-worker thread environment: a private DeviceProver
    cache (the suspend/resume single-driver assumption, per worker)
    pinned to the worker's own CUDA device (``torch.cuda.device``;
    CUDA's current device is per thread). Host-path workers (no device)
    get the cache and no pin."""

    def env(worker):
        from ..zk.prover_fast import worker_isolation

        return worker_isolation(worker.name, worker.device)

    return env


def _shape_params_k(shape_name: str):
    """(CircuitShape, et_params_k, th_params_k) for a served shape
    name."""
    from ..cli.main import ET_PARAMS_K, TH_PARAMS_K
    from ..zk import api as zk

    if shape_name == "tiny":
        return zk.TINY_SHAPE, 20, TH_PARAMS_K
    return zk.DEFAULT_SHAPE, ET_PARAMS_K, TH_PARAMS_K


def _job_device(service):
    """The torch device of a proof job's rounds 3–4: the CPU when the
    service runs on it (``serve --device cpu``: the host prover), else
    the worker's own card, else the service's device."""
    import torch

    from ..zk.prover_fast import current_dp_cache

    dev = getattr(getattr(service, "client", None), "device", None)
    if dev is not None and torch.device(dev).type == "cpu":
        return torch.device("cpu")
    return current_dp_cache().device or dev


class ArtifactCache:
    """Path → bytes, loaded once, identity-stable across jobs."""

    def __init__(self):
        self._cache: dict = {}
        self._lock = threading.Lock()

    def read(self, path) -> bytes:
        key = str(path)
        with self._lock:
            data = self._cache.get(key)
            if data is None:
                try:
                    data = path.read_bytes()
                except OSError as e:
                    raise EigenError(
                        "file_io_error",
                        f"missing proving artifact {path} — generate it "
                        "with the kzg-params / et-proving-key / "
                        "th-proving-key verbs first") from e
                self._cache[key] = data
            return data


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


def make_provers(service, files, shape_name: str = "default",
                 transcript: str = "keccak") -> dict:
    """The default registry for :class:`pool.ProofWorkerPool`: the
    reference's three kinds. ``service`` supplies the live attestation
    set and the Client (domain + circuit hyperparameters); ``files`` is
    the ``cli.fs.EigenFile`` assets layout the batch verbs populate."""
    from ..zk import api as zk

    shape, params_k, th_params_k = _shape_params_k(shape_name)
    cache = ArtifactCache()

    def eigentrust(params: dict) -> dict:
        atts = service.attestation_snapshot()
        setup = service.client.et_circuit_setup(atts)
        tr = params.get("transcript", transcript)
        proof = zk.generate_et_proof(
            cache.read(files.kzg_params(params_k)),
            cache.read(files.et_proving_key()),
            setup, shape=shape, transcript=tr, device=_job_device(service))
        return {
            "proof": proof.hex(),
            "public_inputs": setup.pub_inputs.to_bytes().hex(),
            "transcript": tr,
            "participants": len(setup.address_set),
        }

    def threshold(params: dict) -> dict:
        try:
            peer = bytes.fromhex(
                str(params["peer"]).removeprefix("0x"))
            threshold_v = int(params["threshold"])
        except (KeyError, ValueError) as e:
            raise EigenError(
                "validation_error",
                "threshold jobs need {'peer': '0x…20 bytes', "
                "'threshold': int}") from e
        if len(peer) != 20:
            raise EigenError("validation_error", "peer must be 20 bytes")
        atts = service.attestation_snapshot()
        setup = service.client.th_circuit_setup(atts, peer, threshold_v)
        proof = zk.generate_th_proof(
            cache.read(files.kzg_params(th_params_k)),
            cache.read(files.th_proving_key()),
            setup, device=_job_device(service))
        return {
            "proof": proof.hex(),
            "public_inputs": setup.pub_inputs.to_bytes().hex(),
            "threshold_check": bool(setup.pub_inputs.threshold_check),
        }

    return {"eigentrust": eigentrust, "threshold": threshold,
            "profile": make_profile_prover(files.assets)}
