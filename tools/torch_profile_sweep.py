#!/usr/bin/env python3
"""Where one converge sweep of the torch port spends its time on the card.

    python tools/torch_profile_sweep.py [--peers 1000000] [--sweeps 10]

Builds the Barabási–Albert graph (m=8, seed 0, the converge benchmark
graph), runs ``--sweeps`` routed sweeps (``spmv_routed``) and as many
gather sweeps (``spmv``) in float32 under ``torch.profiler`` and prints,
for each engine, one JSON line: host wall time per sweep, device busy
time per sweep (the union of kernel intervals), the device's idle share
of the window, and device time per kernel name. Needs a CUDA device;
imports nothing of JAX or ``protocol_tpu``.
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


def profile(step, s, sweeps: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        step(s)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(sweeps):
            step(s)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    busy_us = _union_us((e.time_range.start, e.time_range.end)
                        for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {
        "sweeps": sweeps,
        "device_events": len(kernels),
        "wall_ms_per_sweep": wall_us / sweeps / 1e3,
        "device_busy_ms_per_sweep": busy_us / sweeps / 1e3,
        "device_idle_share": (1.0 - busy_us / wall_us) if kernels else None,
        "kernels_ms_per_sweep": {k[:120]: v / sweeps / 1e3 for k, v in top},
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
    rec = profile(lambda v: spmv_routed(arrs, static, v), s, args.sweeps)
    print(json.dumps({"engine": "routed", "peers": n, "card": card, **rec}),
          flush=True)
    del arrs

    gop = build_operator(n, src, dst, val, valid)
    garrs = operator_arrays(gop, dtype=torch.float32, alpha=0.1,
                            device="cuda")
    gs = torch.from_numpy(gop.valid * 1000.0).cuda()
    rec = profile(lambda v: spmv(garrs, v), gs, args.sweeps)
    print(json.dumps({"engine": "gather", "peers": n, "card": card, **rec}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
