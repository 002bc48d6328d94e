"""Fault-injection seam: env-gated failure probabilities on RPC and
device calls.

A daemon's robustness claims (retry-with-backoff, cursor durability,
job retries) are untestable if failures only come from real outages.
This seam lets the test suite — and a chaos-minded operator — dial in
deterministic failure rates:

- ``PTPU_FAULT_RPC``     probability ∈ [0, 1] that a chain RPC call
  raises before hitting the transport,
- ``PTPU_FAULT_DEVICE``  same for device-side calls (converge, prove),
- ``PTPU_FAULT_DISK``    same for durable-store writes (WAL appends,
  snapshot saves, proof artifact persists), except the failure SHAPE
  matters on disk: :meth:`FaultInjector.disk_fault` alternates between
  a **torn write** (partial bytes persisted — the crash shape CRC /
  sidecar recovery must detect and skip) and an **fsync failure**
  (bytes written, durability barrier refused),
- ``PTPU_FAULT_SEED``    integer seed → the failure sequence is
  reproducible run to run.

RPC/device faults are raised as ``EigenError("injected_fault", ...)``
BEFORE the wrapped call executes, so an injected RPC fault can never
half-apply a batch — exactly the failure shape a flaky network produces
at the socket layer. Disk faults are injected INSIDE the store's write
paths (a torn write by definition half-executes). Counters are kept per
kind for ``/metrics``.
"""

from __future__ import annotations

import os
import random
import threading

from ..utils.errors import EigenError


class FaultInjector:
    """Deterministic (seedable) pre-call fault injection by kind."""

    def __init__(self, rates: dict | None = None, seed: int | None = None):
        if rates is None:
            rates = {
                "rpc": float(os.environ.get("PTPU_FAULT_RPC", "0") or 0),
                "device": float(
                    os.environ.get("PTPU_FAULT_DEVICE", "0") or 0),
                "disk": float(
                    os.environ.get("PTPU_FAULT_DISK", "0") or 0),
            }
        for kind, p in rates.items():
            if not 0.0 <= p <= 1.0:
                raise EigenError("config_error",
                                 f"fault rate for {kind!r} must be in "
                                 f"[0, 1], got {p}")
        if seed is None:
            env = os.environ.get("PTPU_FAULT_SEED")
            seed = int(env) if env else None
        self.rates = dict(rates)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: dict = {k: 0 for k in rates}

    def check(self, kind: str) -> None:
        """Raise an injected fault for ``kind`` with its configured
        probability; no-op at rate 0 (the production default)."""
        p = self.rates.get(kind, 0.0)
        if p <= 0.0:
            return
        with self._lock:
            hit = self._rng.random() < p
            if hit:
                self.injected[kind] = self.injected.get(kind, 0) + 1
        if hit:
            raise EigenError("injected_fault",
                             f"injected {kind} fault (rate {p})")

    def disk_fault(self) -> str | None:
        """For store write paths: None (no fault) or a failure shape —
        ``"torn"`` (partial write persisted) or ``"fsync"`` (write
        persisted, durability barrier fails). Counted under ``disk``;
        the shape choice draws from the same seeded stream, so runs
        are reproducible end to end."""
        p = self.rates.get("disk", 0.0)
        if p <= 0.0:
            return None
        with self._lock:
            if self._rng.random() >= p:
                return None
            self.injected["disk"] = self.injected.get("disk", 0) + 1
            return "torn" if self._rng.random() < 0.5 else "fsync"

    def call(self, kind: str, fn, *args, **kwargs):
        """``check(kind)`` then run ``fn`` — the one-line wrap used at
        every seam call site."""
        self.check(kind)
        return fn(*args, **kwargs)
