"""Thread-stall watchdog: heartbeats for every long-lived service
thread, exported as gauges and escalated through the SLO path.

A stalled tailer (wedged RPC), refresher (device hang), or pool worker
(native call that never returns) is indistinguishable from an idle one
on every observability surface — the counters just stop moving. The
watchdog makes stalls first-class:

- each service loop registers with :func:`Heartbeats.register` and
  calls :meth:`beat` at the top of every iteration (loops already wake
  at least every poll interval, so a healthy idle thread never looks
  stalled);
- a ``ptpu-watchdog`` thread exports
  ``ptpu_thread_heartbeat_age_seconds{thread=...}`` and
  ``ptpu_thread_stalled{thread=...}`` every tick;
- the first tick a thread crosses ``stall_after``, the watchdog dumps
  that thread's stack into the flight-recorder ring and triggers an
  incident capture (rate-limited by the store); recovery is latched
  back down as soon as the thread beats again;
- :meth:`max_age` feeds the ``thread_stall`` gauge-kind SLO, so a
  sustained stall pages through the same burn-rate path as every
  other objective — no parallel alerting channel.

Deregistration matters: drained threads (shutdown, pool resize) call
:meth:`unregister` so a *retired* thread is not an eternal stall.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback

from ..utils import trace


class Heartbeats:
    """Thread heartbeat registry, keyed by stable role name."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"t": last beat monotonic, "ident": thread ident}
        self._beats: dict = {}

    def register(self, name: str) -> None:
        self.beat(name)

    def beat(self, name: str) -> None:
        with self._lock:
            self._beats[name] = {"t": time.monotonic(),
                                 "ident": threading.get_ident()}

    def unregister(self, name: str) -> None:
        with self._lock:
            self._beats.pop(name, None)

    def ages(self, now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        with self._lock:
            return {name: {"age": now - row["t"],
                           "ident": row["ident"]}
                    for name, row in self._beats.items()}

    def max_age(self, now: float | None = None) -> float | None:
        ages = self.ages(now)
        if not ages:
            return None
        return max(row["age"] for row in ages.values())


class StallWatchdog:
    """The ``ptpu-watchdog`` thread: export ages, latch stalls,
    trigger incidents."""

    def __init__(self, beats: Heartbeats, recorder=None, store=None,
                 interval: float = 1.0, stall_after: float = 30.0):
        self.beats = beats
        self.recorder = recorder
        self.store = store
        self.interval = float(interval)
        self.stall_after = float(stall_after)
        self._stalled: set = set()
        self._thread: threading.Thread | None = None
        self._stop: threading.Event | None = None

    # --- one evaluation tick (directly testable) ---------------------------

    def check(self, now: float | None = None) -> list:
        """Export gauges, detect new stalls/recoveries; returns the
        names that STARTED stalling this tick."""
        ages = self.beats.ages(now)
        age_gauge = trace.gauge("thread_heartbeat_age_seconds")
        stall_gauge = trace.gauge("thread_stalled")
        fired = []
        for name, row in ages.items():
            age_gauge.set(row["age"], thread=name)
            stalled = row["age"] > self.stall_after
            stall_gauge.set(1.0 if stalled else 0.0, thread=name)
            if stalled and name not in self._stalled:
                self._stalled.add(name)
                fired.append(name)
                self._on_stall(name, row)
            elif not stalled and name in self._stalled:
                self._stalled.discard(name)
                if self.recorder is not None:
                    self.recorder.note("thread_recovered", thread=name)
                trace.event("watchdog.recovered", thread=name)
        # retired threads: drop their series out of the stalled latch
        self._stalled &= set(ages)
        return fired

    def _on_stall(self, name: str, row: dict) -> None:
        frame = sys._current_frames().get(row["ident"])
        stack = traceback.format_stack(frame) if frame else []
        if self.recorder is not None:
            self.recorder.note("thread_stalled", thread=name,
                               age=round(row["age"], 3),
                               stack="".join(stack[-4:]))
        trace.event("watchdog.stalled", thread=name,
                    age=round(row["age"], 3))
        trace.counter("thread_stalls").inc(thread=name)
        if self.store is not None:
            self.store.capture(
                "watchdog", f"thread {name} stalled "
                f"({row['age']:.1f}s since last heartbeat)",
                context={"stalled_thread": {
                    "thread": name, "age": row["age"],
                    "stack": stack}})

    def stalled(self) -> list:
        return sorted(self._stalled)

    # --- thread lifecycle ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="ptpu-watchdog", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        # check-then-wait: the heartbeat gauges exist from the first
        # scrape, not one interval after start
        while True:
            try:
                self.check()
            except Exception:  # noqa: BLE001 - the watchdog never dies
                pass
            if self._stop.wait(self.interval):
                return

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._thread = None
