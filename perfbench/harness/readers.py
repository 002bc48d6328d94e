"""What the metric files read from a run.

A run is a dict: ``setup_s``; ``requests``, one dict per request of the
window in order (``t0``/``t1`` host clock, ``wall_s``, ``iterations``,
``ok``, ``profiled``; in a traced run ``loop_s``, the program's span
named by the entry's ``LOOP_SPAN``, and where the entry times it
``apply_s``);
``info``, the numbers the set-up recorded (graph and plan sizes,
``plan_build_s``); ``profile``, the :class:`harness.profile.Profile` of
a traced run's first requests, or None. Each function returns None
where it finds nothing to read.
"""

from __future__ import annotations

import numpy as np

from .profile import B1_KERNEL
from .roofline import (
    HBM_BYTES_PER_S,
    b1_bytes_per_sweep,
    b1_launches_per_sweep,
    sweep_min_bytes,
)


def _unprofiled(run: dict, key: str) -> list:
    """The requests outside the profiled block that carry ``key``: the
    profiler slows the host, so span readings come from the rest."""
    return [r for r in run["requests"] if not r["profiled"] and key in r]


def mean_wall_ms(run: dict):
    walls = [r["wall_s"] for r in run["requests"]]
    return 1e3 * sum(walls) / len(walls) if walls else None


def window_ms_per_request(run: dict):
    reqs = run["requests"]
    if not reqs:
        return None
    return 1e3 * (reqs[-1]["t1"] - reqs[0]["t0"]) / len(reqs)


def p95_wall_ms(run: dict):
    walls = [r["wall_s"] for r in run["requests"]]
    return 1e3 * float(np.percentile(walls, 95)) if walls else None


def sweep_ms(run: dict):
    rs = [r for r in _unprofiled(run, "loop_s") if r["iterations"] > 0]
    iters = sum(r["iterations"] for r in rs)
    return 1e3 * sum(r["loop_s"] for r in rs) / iters if iters else None


def sweeps_per_request(run: dict):
    reqs = run["requests"]
    return (sum(r["iterations"] for r in reqs) / len(reqs)) if reqs else None


def apply_ms(run: dict):
    rs = _unprofiled(run, "apply_s")
    return 1e3 * sum(r["apply_s"] for r in rs) / len(rs) if rs else None


def outside_loop_ms(run: dict):
    rs = _unprofiled(run, "loop_s")
    if not rs:
        return None
    return 1e3 * sum(r["wall_s"] - r["loop_s"] for r in rs) / len(rs)


def _profiled_iterations(run: dict) -> int:
    return sum(r["iterations"] for r in run["requests"] if r["profiled"])


def idle_share(run: dict):
    p = run.get("profile")
    if p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def sweep_roofline(run: dict):
    """Least bytes of a sweep at the HBM peak, over the device busy
    time per sweep inside the program's adaptive-loop spans."""
    p = run.get("profile")
    iters = _profiled_iterations(run)
    if p is None or not iters:
        return None
    busy = p.busy_within_s("span:converge.edges")
    if busy <= 0:
        return None
    least_s = sweep_min_bytes(run["info"]) / HBM_BYTES_PER_S
    return 100.0 * least_s / (busy / iters)


def b1_roofline(run: dict):
    """B1's bytes at the HBM peak over B1's device time by kernel name.
    Silent where the launches seen are not the plan's launches per
    sweep times the sweeps (the bytes would then be counted wrong)."""
    p = run.get("profile")
    iters = _profiled_iterations(run)
    if p is None or not iters:
        return None
    seconds, launches = p.kernel_s(B1_KERNEL)
    info = run["info"]
    if not launches or launches != iters * b1_launches_per_sweep(info):
        return None
    least_s = iters * b1_bytes_per_sweep(info) / HBM_BYTES_PER_S
    return 100.0 * least_s / seconds
