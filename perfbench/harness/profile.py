"""The device trace of a traced run, and what the readers take from it.

A traced run profiles the first requests of its window under
``torch.profiler`` (CPU and CUDA activity). The harness marks its own
phases with ``record_function`` ranges named ``phase:<name>``
(``request``, ``draw``, ``apply``), and while the profiler runs it
bridges the program's tracer spans into the same clock: every span the
program opens also opens a range named ``span:<name>``
(``span:converge.edges`` is the adaptive loop). Nothing else of the
program is touched, and the bridge is removed when the profile ends.

The union of intervals and the profile reading follow
``tools/torch_profile_sweep.py``.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

B1_KERNEL = "route_stage_kernel"
_MARKS = ("phase:", "span:")


def union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(intervals, lo: float, hi: float) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


@dataclass
class Profile:
    """The profiled part of a window, in microseconds of the profiler's
    clock. ``device`` holds every kernel, copy and memset
    ``(name, start, end)``; ``ranges`` every ``phase:``/``span:`` range
    ``(name, start, end)``."""

    device: list = field(default_factory=list)
    ranges: list = field(default_factory=list)

    def named(self, name: str) -> list:
        return [(a, b) for n, a, b in self.ranges if n == name]

    @property
    def window(self) -> tuple:
        reqs = self.named("phase:request")
        if not reqs:
            return (0.0, 0.0)
        return (min(a for a, _ in reqs), max(b for _, b in reqs))

    @property
    def window_s(self) -> float:
        lo, hi = self.window
        return (hi - lo) / 1e6

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return union_us(clipped([(a, b) for _, a, b in self.device],
                                lo, hi)) / 1e6

    def busy_within_s(self, range_name: str) -> float:
        """Device busy time inside the ranges called ``range_name``."""
        busy = merged((a, b) for _, a, b in self.device)
        total = 0.0
        for lo, hi in merged(self.named(range_name)):
            total += union_us(clipped(busy, lo, hi))
        return total / 1e6

    def kernel_s(self, needle: str) -> tuple:
        """(seconds, launches) of the device events whose name holds
        ``needle``."""
        hits = [(a, b) for n, a, b in self.device if needle in n]
        return sum(b - a for a, b in hits) / 1e6, len(hits)

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for n, a, b in self.device:
            by[short_name(n)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time of the device in the window, summed by what the
        host was doing: ``loop`` (inside the adaptive loop's span),
        ``apply`` (applying a churn batch), ``upload`` and ``publish``
        (inside a request, before and after its loop), ``draw`` (the
        traffic generator), ``between`` (none of these)."""
        lo, hi = self.window
        busy = merged(clipped([(a, b) for _, a, b in self.device], lo, hi))
        gaps, t = [], lo
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        loops = self.named("span:converge.edges")
        applies = self.named("phase:apply")
        draws = self.named("phase:draw")
        reqs = self.named("phase:request")
        by = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            by[_label(mid, loops, applies, draws, reqs)] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]


def _inside(t: float, ranges) -> tuple | None:
    for a, b in ranges:
        if a <= t <= b:
            return (a, b)
    return None


def _label(t, loops, applies, draws, reqs) -> str:
    if _inside(t, loops):
        return "loop"
    if _inside(t, applies):
        return "apply"
    if _inside(t, draws):
        return "draw"
    req = _inside(t, reqs)
    if req:
        later = [a for a, _ in loops if t < a <= req[1]]
        return "upload" if later else "publish"
    return "between"


def short_name(name: str) -> str:
    """A kernel's name without its argument list, ``void`` and
    namespaces of the form ``at::native::``."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.removeprefix("void ").replace("at::native::", "")
    return name.replace("(anonymous namespace)::", "").strip()[:96]


class Recorder:
    """Profiles a block of requests and bridges the program's spans.
    ``phase(name)`` marks a harness phase; a no-op when not profiling."""

    def __init__(self, tracer=None):
        self.tracer = tracer      # the program's tracer, for the bridge
        self.active = False
        self.profile: Profile | None = None

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.active:
            yield
            return
        from torch.profiler import record_function

        with record_function("phase:" + name):
            yield

    @contextlib.contextmanager
    def profiling(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        bridged = self._bridge()
        self.active = True
        try:
            with profile(activities=acts) as prof:
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self.active = False
            if bridged:
                del self.tracer.span
        self.profile = read_profile(prof)

    def _bridge(self) -> bool:
        if self.tracer is None:
            return False
        from torch.profiler import record_function

        orig = self.tracer.span

        @contextlib.contextmanager
        def span(name, **fields):
            with record_function("span:" + name):
                with orig(name, **fields):
                    yield

        self.tracer.span = span
        return True


def read_profile(prof) -> Profile:
    from torch.autograd import DeviceType

    out = Profile()
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start, e.time_range.end
        if name.startswith(_MARKS):
            if e.device_type == DeviceType.CPU:
                out.ranges.append((name, start, end))
            continue  # the device side's copy of a range is no work
        if e.device_type == DeviceType.CUDA:
            out.device.append((name, start, end))
    return out
