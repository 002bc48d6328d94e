#!/usr/bin/env python3
"""Where one converge sweep of the torch port spends its time on the card.

    python tools/torch_profile_sweep.py [--peers 1000000] [--sweeps 10]

Builds the Barabási–Albert graph (m=8, seed 0, the converge benchmark
graph), runs ``--sweeps`` routed sweeps (``spmv_routed``), as many edge
routes alone (``route_core``: one route-stage launch per stage, so
``device_events`` is the stage count) and as many gather sweeps
(``spmv``) in float32 under ``torch.profiler`` and prints, for each, one
JSON line: host wall time per sweep, device busy time per sweep (the
union of kernel intervals), the device's idle share of the window, and
device time and events per kernel name. Needs a CUDA device; imports
nothing of JAX or ``protocol_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _union_us(intervals) -> float:
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


def profile(run, repeats: int = 1, warmup: int = 1, reset=None) -> dict:
    """Calls ``run()`` ``warmup`` times, then ``reset()`` if given, then
    ``repeats`` times under ``torch.profiler``. Returns, per repeat, the
    host wall time, the device busy time (the union of kernel intervals),
    device time and events per kernel name, the copy events, and the
    device's idle share of the profiled window. Shared with
    ``torch_profile_ingest.py``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        run()
    torch.cuda.synchronize()
    if reset is not None:
        reset()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    count = defaultdict(int)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
        count[e.name] += 1
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "repeats": repeats,
        "device_events": len(kernels),
        "wall_ms": wall_us / repeats / 1e3,
        "device_busy_ms": busy_us / repeats / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if kernels else None,
        "kernels_ms": {k[:120]: v / repeats / 1e3 for k, v in top},
        # copies and memcpys: what a strided or broadcast operand costs
        "copy_events": sum(c for k, c in count.items()
                           if "copy" in k.lower()) / repeats,
        "events_by_name": {k[:120]: c / repeats for k, c in sorted(
            count.items(), key=lambda kv: -kv[1])[:12]},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peers", type=int, default=1_000_000)
    ap.add_argument("--sweeps", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from protocol_tpu_torch.graph import barabasi_albert_edges, build_operator
    from protocol_tpu_torch.ops.clos import route_core
    from protocol_tpu_torch.ops.converge import operator_arrays, spmv
    from protocol_tpu_torch.ops.routed import (
        build_routed_operator,
        routed_arrays,
        spmv_routed,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    n = args.peers
    src, dst, val = barabasi_albert_edges(n, 8, seed=0)
    valid = np.ones(n, dtype=bool)

    op = build_routed_operator(n, src, dst, val, valid)
    arrs, static = routed_arrays(op, dtype=torch.float32, alpha=0.1,
                                 device="cuda")
    s = torch.from_numpy(op.initial_scores(1000.0)).cuda()
    rec = profile(lambda: spmv_routed(arrs, static, s), args.sweeps,
                  warmup=3)
    print(json.dumps({"engine": "routed", "peers": n, "card": card, **rec}),
          flush=True)
    x = torch.randn(1 << static.edge_e, device="cuda")
    rec = profile(lambda: route_core(x, arrs["edge_stages"], 0,
                                     static.edge_e, static.edge_bits),
                  args.sweeps, warmup=3)
    print(json.dumps({"engine": "routed", "part": "edge_route", "peers": n,
                      "stages": len(arrs["edge_stages"]), "card": card,
                      **rec}), flush=True)
    del arrs, x

    gop = build_operator(n, src, dst, val, valid)
    garrs = operator_arrays(gop, dtype=torch.float32, alpha=0.1,
                            device="cuda")
    gs = torch.from_numpy(gop.valid * 1000.0).cuda()
    rec = profile(lambda: spmv(garrs, gs), args.sweeps, warmup=3)
    print(json.dumps({"engine": "gather", "peers": n, "card": card, **rec}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
