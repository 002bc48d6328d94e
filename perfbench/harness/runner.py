"""One run of one cell: set-up, the measured window, the check.

``run_cell`` is the whole run but the look for a card and the printing,
which ``perfbench/run.py`` does; the tests drive it on the CPU at a
small size.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np

from . import cell as cells
from .profile import Recorder

SEED_MASK = (1 << 63) - 1


@dataclass
class Context:
    """What an entry sees: the configuration and the mix's parameters,
    the seed, the device, the traffic's random stream, and ``info``,
    where set-up and the entry record numbers for the readers and the
    earlier lines."""

    config: dict
    params: dict
    seed: int
    device: object
    trace: bool
    recorder: Recorder
    rng: np.random.Generator
    info: dict


class Sample:
    """A sample of the window's answers drawn from the seed: a
    reservoir of ``k`` and always the last answer."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = int(k), rng
        self.slots: list = []
        self.seen = 0
        self.last = None

    def offer(self, i: int, answer) -> None:
        if len(self.slots) < self.k:
            self.slots.append((i, answer))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = (i, answer)
        self.seen += 1
        self.last = (i, answer)

    def picks(self) -> list:
        kept = dict(self.slots)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        return sorted(kept.items())


def _span_seconds(tracer, cursor: int, name: str) -> tuple:
    """Summed duration of the program's ``name`` spans closed since
    span id ``cursor``, and the new cursor."""
    recs, cursor = tracer.recent_spans(after_id=cursor, limit=4096)
    return sum(r["duration_s"] for r in recs if r["name"] == name), cursor


def run_window(ctx: Context, entry, state, seconds: float, sample: Sample,
               tracer=None) -> list:
    """The closed loop: one client sends the next request when the last
    has returned, until ``seconds`` have passed since the first; the
    request in flight then completes. A traced run first profiles
    ``trace_requests`` requests, then runs its ``seconds`` unprofiled:
    reading the profile takes seconds of its own. A request that raises
    ends the window (the program's state is then unknown) and counts as
    failed."""
    rec = ctx.recorder
    loop_span = getattr(entry, "LOOP_SPAN", None)
    requests: list = []
    cursor = _span_seconds(tracer, 0, "")[1] if tracer is not None else 0

    def one(profiled: bool) -> bool:
        nonlocal cursor
        with rec.phase("draw"):
            req = entry.draw(ctx, state)
        r = {"profiled": profiled, "iterations": 0, "ok": False}
        answer = None
        with rec.phase("request"):
            r["t0"] = time.perf_counter()
            try:
                answer, info = entry.serve(ctx, state, req)
                r.update(info)
                r["ok"] = bool(info.get("ok", True))
            except Exception:  # the run reports it as a failed request
                traceback.print_exc(file=sys.stderr)
                r["error"] = True
            r["t1"] = time.perf_counter()
        r["wall_s"] = r["t1"] - r["t0"]
        if tracer is not None and loop_span:
            r["loop_s"], cursor = _span_seconds(tracer, cursor, loop_span)
        sample.offer(len(requests), answer)
        requests.append(r)
        return not r.get("error")

    alive = True
    if ctx.trace and int(ctx.params.get("trace_requests", 0)):
        with rec.profiling():
            while alive and len(requests) < int(ctx.params["trace_requests"]):
                alive = one(True)
    first = len(requests)
    while alive:
        alive = one(False)
        if time.perf_counter() >= requests[first]["t0"] + seconds:
            break
    return requests


def judge(entry, limits: dict, requests: list, picks: list,
          refs: list) -> tuple:
    """The verdict on a window: every request served and stopped on its
    own rule, and the worst of each number that ``entry.compare`` gives
    over the sampled answers ``picks`` against the reference's answers
    ``refs`` under its limit. Returns ``(correct, numbers)``. The
    control is judged by the same call, its answers in place of the
    program's."""
    worst = {k: 0.0 for k in limits}
    for (_, answer), ref in zip(picks, refs):
        for k, v in entry.compare(answer, ref).items():
            if k in worst:
                worst[k] = max(worst[k], v)
    failed = sum(1 for r in requests if not r["ok"])
    correct = (bool(requests) and bool(picks) and failed == 0
               and all(worst[k] <= lim for k, lim in limits.items()))
    return correct, worst


def free_device(device) -> None:
    gc.collect()
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def prepare(cell: cells.Cell, seed: int, trace: bool, device,
            config: dict | None = None):
    """Set the cell's entry up from the seed. Returns ``(ctx, entry,
    state, tracer)``; ``tracer`` is the program's, enabled in memory,
    in a traced run, else None."""
    import torch

    device = torch.device(device)
    seed = int(seed) & SEED_MASK
    free_device(device)
    tracer = None
    if trace:
        from protocol_tpu_torch.utils import trace as ptrace

        ptrace.enable()
        tracer = ptrace.TRACER
    ctx = Context(config=dict(cell.config if config is None else config),
                  params=cell.traffic, seed=seed, device=device,
                  trace=bool(trace), recorder=Recorder(tracer),
                  rng=np.random.default_rng([seed, 1]), info={})
    entry = cells.entry(cell.entry)
    return ctx, entry, entry.setup(ctx), tracer


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device, config: dict | None = None,
             process_t0: float | None = None) -> dict:
    """Set up, measure for ``seconds``, check. The entry
    (``entries/<entry>.py``) owns everything of the system under test:
    ``setup``, ``draw``, ``serve``, ``release``, ``describe`` (numbers
    for the earlier lines, after the window), ``reference`` and
    ``control`` (the answers the sample is judged against, and the
    control's) and ``compare``. Returns the result's
    fields (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, ``breakdown``, ``check``) and ``lines``, the earlier
    lines to print."""
    import torch

    t_proc = time.perf_counter() if process_t0 is None else process_t0
    ctx, entry, state, tracer = prepare(cell, seed, trace, device, config)
    device = ctx.device
    setup_info = dict(ctx.info)
    sample = Sample(cell.sample, np.random.default_rng([ctx.seed, 2]))
    requests = run_window(ctx, entry, state, seconds, sample, tracer)
    setup_s = (requests[0]["t0"] - t_proc) if requests else None
    peak = (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)
    window = entry.describe(ctx, state, requests)
    entry.release(ctx, state)
    free_device(device)
    run = {"setup_s": setup_s, "requests": requests, "info": ctx.info,
           "profile": ctx.recorder.profile}
    picks = sample.picks()
    refs = entry.reference(ctx, state, [i for i, _ in picks])
    correct, numbers = judge(entry, cell.limits, requests, picks, refs)
    failed = sum(1 for r in requests if not r["ok"])

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(requests), "failed": failed,
           "metrics": metrics, "device": dev}
    prof = ctx.recorder.profile
    if trace and prof is not None:
        dev["busy_s"] = prof.busy_s
        dev["window_s"] = prof.window_s
        out["breakdown"] = {"device_ops": prof.top_ops(),
                            "idle_gaps": prof.idle_gaps()}
    out["check"] = {k: {"value": numbers[k], "limit": cell.limits[k]}
                    for k in cell.limits}
    walls = np.array([r["wall_s"] for r in requests]) * 1e3
    quarters = [float(q.mean()) for q in np.array_split(walls, 4) if len(q)]
    out["lines"] = [
        {"perfbench": "setup", "cell": cell.name, "seed": ctx.seed,
         **setup_info},
        {"perfbench": "window", "requests": len(requests), **window,
         "picks": [i for i, _ in picks],
         "wall_ms_quantiles": [float(x) for x in np.percentile(
             walls, [0, 5, 25, 50, 75, 95, 100])] if len(walls) else [],
         "wall_ms_quarter_means": quarters},
        {"perfbench": "graph", **{k: v for k, v in ctx.info.items()
                                  if k not in setup_info}},
    ]
    if trace:
        from protocol_tpu_torch.utils import trace as ptrace

        ptrace.disable()
    return out
