#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card. It
builds the port's kernel (nvcc) and Clos planner (g++) from the sources
in the checkout, holds the lane-permutation kernel bit for bit against
its plain PyTorch version, times it beside its memory bound, its plain
version and ``torch.gather``, then runs the Clos-routed EigenTrust
converge at 1M peers (Barabási–Albert, m=8, seed 0, both directions
attested: the repo's converge benchmark graph) through
``TorchRoutedBackend`` and checks it against the float64 gather path on
the same card, the ``entry()`` twin against its CPU run, and the
``sparse-scores`` CLI on a 100K-peer edge list.

Every phase prints one JSON line; any failed check exits non-zero. The
last lines are the ``kernels`` record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. With no CUDA device, or outside
the repository, it exits non-zero and prints no result. Imports nothing
of JAX or of ``protocol_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)

N_PEERS = 1_000_000            # main-path size: the converge benchmark graph
BA_M = 8
ALPHA = 0.1
TOL = 1e-6
MAX_ITERATIONS = 100
CLI_PEERS = 100_000


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def phase_build() -> None:
    from protocol_tpu_torch import native
    from protocol_tpu_torch.ops.kernels import lane_perm_kernel as lp

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return time.perf_counter() - t0, str(path.relative_to(ROOT))

    # one compiler per source, started together
    with ThreadPoolExecutor(max_workers=2) as pool:
        nv = pool.submit(timed, lp.build)
        gx = pool.submit(timed, native.build)
        (nvcc_s, nvcc_lib), (gxx_s, gxx_lib) = nv.result(), gx.result()
    check(native.available(), "native planner did not load")
    emit("build", nvcc_s=nvcc_s, nvcc_lib=nvcc_lib, gxx_s=gxx_s,
         gxx_lib=gxx_lib)


def phase_kernel_vs_plain(device) -> float:
    """Bit-exact lane_perm vs plain on the card; returns max |err|."""
    import numpy as np
    import torch

    from protocol_tpu_torch.ops.clos import apply_route, apply_route_np, plan_route
    from protocol_tpu_torch.ops.kernels import lane_perm, lane_perm_plain

    rng = np.random.default_rng(1)
    worst = 0.0
    cases = []
    for dtype in (torch.float32, torch.float64):
        # 1 and 7 rows (below the TPU kernel's 8-row tile), both main-path
        # row counts, and one whose last tile is ragged for either dtype
        for T in (1, 7, 8192, 262_144, 1000):
            x = torch.from_numpy(rng.standard_normal((T, 128))).to(
                device=device, dtype=dtype)
            idx = torch.from_numpy(
                rng.integers(0, 128, (T, 128), dtype=np.uint8)).to(device)
            y = lane_perm(x, idx)
            torch.cuda.synchronize()
            ref = lane_perm_plain(x, idx)
            err = float((y - ref).abs().max())
            exact = bool(torch.equal(y, ref))
            worst = max(worst, err)
            cases.append({"dtype": str(dtype).split(".")[1], "T": T,
                          "bit_exact": exact, "max_abs_err": err})
            check(exact, f"lane_perm differs from plain at {dtype}, T={T}")
    emit("kernel_vs_plain", cases=cases)

    e = 20
    perm = rng.permutation(1 << e)
    t0 = time.perf_counter()
    plan = plan_route(perm)
    plan_s = time.perf_counter() - t0
    x = rng.standard_normal(1 << e).astype(np.float32)
    stages = tuple(torch.from_numpy(s).to(device) for s in plan.stages)
    y = apply_route(torch.from_numpy(x).to(device), stages, plan.e, plan.bits)
    y = y.cpu().numpy()
    exact = bool(np.array_equal(y, apply_route_np(plan, x))
                 and np.array_equal(y, x[perm]))
    emit("route_vs_numpy", e=e, bits=list(plan.bits), plan_s=plan_s,
         bit_exact=exact)
    check(exact, "routed permutation at e=20 differs from apply_route_np")
    return worst


def phase_kernel_times(device) -> dict:
    """Kernel, plain version and torch.gather at the main path's shapes
    (float32): T = 262,144 rows (edge route) and 8,192 (state route)."""
    import torch

    from protocol_tpu_torch.ops.kernels import lane_perm, lane_perm_plain

    g = torch.Generator(device=device).manual_seed(2)
    rows = {}
    for T, iters in ((262_144, 50), (8192, 200)):
        x = torch.randn(T, 128, device=device, generator=g)
        idx = torch.randint(0, 128, (T, 128), device=device, generator=g,
                            dtype=torch.uint8)
        idx64 = idx.long()
        nbytes = T * 128 * (4 + 1 + 4)  # x read, idx read, out written
        rows[T] = {
            "T": T,
            "ms": cuda_ms(lambda: lane_perm(x, idx), iters),
            "plain_ms": cuda_ms(lambda: lane_perm_plain(x, idx), iters),
            "library_ms": cuda_ms(lambda: torch.gather(x, 1, idx64), iters),
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        rows[T]["achieved_GBps"] = nbytes / rows[T]["ms"] / 1e6
        emit("kernel_times", **rows[T], dtype="float32")
    return rows


def _sweep_breakdown(arrs, static, s, iters: int = 10) -> dict:
    """Device ms per stage of one routed sweep, by CUDA events."""
    import torch

    from protocol_tpu_torch.ops.clos import route_core
    from protocol_tpu_torch.ops.converge import dangling_and_damping
    from protocol_tpu_torch.ops.routed import blocked_broadcast, blocked_reduce

    stages = {
        "broadcast": lambda s: blocked_broadcast(
            arrs, s, static.out_widths, static.out_xs, 1 << static.edge_e),
        "edge_route": lambda x: route_core(
            x, arrs["edge_stages"], 0, static.edge_e, static.edge_bits),
        "reduce": lambda y: blocked_reduce(
            arrs, y, static.in_widths, static.in_xs, static.in_n_pos,
            1 << static.state_e),
        "state_route": lambda z: route_core(
            z, arrs["state_stages"], 0, static.state_e, static.state_bits),
    }
    out = {}
    v = s
    for name, fn in stages.items():
        arg = v
        out[name] = cuda_ms(lambda: fn(arg), iters)
        v = fn(arg)
    out["dangling_damping"] = cuda_ms(
        lambda: dangling_and_damping(arrs, s, v), iters)
    # the edge route's transposes alone (its lane_perm launches are the
    # kernel_times row at T = 2^edge_e / 128)
    E = 1 << static.edge_e
    x = torch.empty(E, device=s.device)
    t = 0.0
    for li in range(len(static.edge_bits) - 1):
        El = 1 << (static.edge_e - 7 * li)
        B, m = E // El, El >> 7
        t += cuda_ms(lambda: x.view(B, m, 128).transpose(1, 2).reshape(E),
                     iters)
        t += cuda_ms(lambda: x.view(B, 128, m).transpose(1, 2).reshape(E),
                     iters)
    out["edge_route_transposes"] = t
    torch.cuda.synchronize()
    return out


def phase_main_path(device) -> int:
    """The 1M-peer routed converge through TorchRoutedBackend; returns the
    lane_perm launches it made."""
    import numpy as np
    import torch

    from protocol_tpu_torch.backend import TorchRoutedBackend, TorchSparseBackend
    from protocol_tpu_torch.graph import barabasi_albert_edges
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.converge import operator_arrays, spmv
    from protocol_tpu_torch.graph import build_operator
    from protocol_tpu_torch.ops.routed import (
        build_routed_operator,
        routed_arrays,
        spmv_routed,
    )

    n = N_PEERS
    t0 = time.perf_counter()
    src, dst, val = barabasi_albert_edges(n, BA_M, seed=0)
    graph_s = time.perf_counter() - t0
    valid = np.ones(n, dtype=bool)
    t0 = time.perf_counter()
    op = build_routed_operator(n, src, dst, val, valid)
    plan_build_s = time.perf_counter() - t0
    stages_per_sweep = len(op.edge_stages) + len(op.state_stages)
    emit("operator", peers=n, m=BA_M, raw_edges=len(src),
         filtered_edges=int(op.nnz), n_valid=int(op.n_valid),
         edge_e=op.edge_e, edge_bits=list(op.edge_bits),
         state_e=op.state_e, state_bits=list(op.state_bits),
         out_widths=list(op.out_widths), in_widths=list(op.in_widths),
         lane_perm_per_sweep=stages_per_sweep,
         graph_gen_s=graph_s, plan_build_s=plan_build_s)

    backend = TorchRoutedBackend(dtype=torch.float32, device=device)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    scores, iters, delta = backend.converge_edges(
        n, src, dst, val, valid, 1000.0, MAX_ITERATIONS, tol=TOL,
        alpha=ALPHA, operator=op)
    torch.cuda.synchronize()
    converge_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["lane_perm"]

    # per-sweep device time and its breakdown, outside the counted run
    arrs, static = routed_arrays(op, dtype=torch.float32, alpha=ALPHA,
                                 device=device)
    s = torch.from_numpy(op.initial_scores(1000.0)).to(device)
    sweep_ms = cuda_ms(lambda: spmv_routed(arrs, static, s), 10)
    breakdown = _sweep_breakdown(arrs, static, s)
    del arrs

    total = op.n_valid * 1000.0
    cons = abs(float(np.sum(scores, dtype=np.float64)) - total) / total
    finite = bool(np.isfinite(scores).all())

    # the card's float64 gather path on the same edges
    t0 = time.perf_counter()
    g64, g_iters, g_delta = TorchSparseBackend(
        dtype=torch.float64, device=device).converge_edges(
        n, src, dst, val, valid, 1000.0, MAX_ITERATIONS, tol=TOL, alpha=ALPHA)
    torch.cuda.synchronize()
    gather64_s = time.perf_counter() - t0
    close = bool(np.allclose(scores, g64, rtol=1e-4, atol=0.5))
    max_abs = float(np.max(np.abs(scores.astype(np.float64) - g64)))

    # float32 gather per-sweep time: the in-package yardstick
    gop = build_operator(n, src, dst, val, valid)
    garrs = operator_arrays(gop, dtype=torch.float32, alpha=ALPHA,
                            device=device)
    gs = torch.from_numpy(gop.valid * 1000.0).to(device)
    gather_sweep_ms = cuda_ms(lambda: spmv(garrs, gs), 10)
    del garrs

    emit("main_path", engine="routed", dtype="float32", alpha=ALPHA,
         tol=TOL, iterations=iters, delta=delta, converge_s=converge_s,
         sweep_ms=sweep_ms, sweep_breakdown_ms=breakdown,
         gather_f32_sweep_ms=gather_sweep_ms,
         conservation_rel_err=cons, finite=finite,
         gather_f64_iterations=g_iters, gather_f64_delta=g_delta,
         gather_f64_converge_s=gather64_s,
         max_abs_diff_vs_gather_f64=max_abs, allclose_vs_gather_f64=close,
         lane_perm_launches=launches,
         expected_launches=iters * stages_per_sweep,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    check(stages_per_sweep == 12, "1M-peer operator should run 12 "
          f"lane_perm stages per sweep, has {stages_per_sweep}")
    check(finite, "non-finite scores")
    check(delta <= TOL, f"routed converge stopped at delta {delta} > tol")
    check(cons < 1e-4, f"mass not conserved: rel err {cons}")
    check(abs(iters - g_iters) <= 1,
          f"iterations {iters} vs float64 gather {g_iters}")
    check(close, "routed scores differ from the float64 gather path "
          f"(max |diff| {max_abs})")
    check(launches == iters * stages_per_sweep,
          f"lane_perm launched {launches} times, expected "
          f"{iters} sweeps × {stages_per_sweep}")
    return launches


def phase_entry(device) -> None:
    import numpy as np

    from protocol_tpu_torch.entry import entry
    from protocol_tpu_torch.ops import kernels

    fn, args = entry(device=device)
    kernels.reset_launches()
    out = fn(*args).cpu().numpy()
    launches = kernels.LAUNCHES["lane_perm"]
    fn_cpu, args_cpu = entry(device="cpu")
    want = fn_cpu(*args_cpu).numpy()
    stages = len(args[0]["edge_stages"]) + len(args[0]["state_stages"])
    close = bool(np.allclose(out, want, rtol=1e-4, atol=0.5))
    emit("entry", sweeps=20, lane_perm_launches=launches,
         max_abs_diff_vs_cpu=float(np.max(np.abs(out - want))),
         allclose_vs_cpu=close, sum=float(out.sum(dtype=np.float64)))
    check(np.isfinite(out).all() and close, "entry() on CUDA differs from CPU")
    check(launches == 20 * stages, "entry() did not run the lane_perm kernel")


def phase_cli() -> None:
    import numpy as np

    from protocol_tpu_torch.graph import barabasi_albert_edges

    n = CLI_PEERS
    src, dst, val = barabasi_albert_edges(n, BA_M, seed=1)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        np.savetxt(Path(d) / "edges.csv",
                   np.stack([src, dst, val.astype(np.int64)], axis=1),
                   fmt="%d", delimiter=",")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets", d,
             "sparse-scores", "--edges", "edges.csv", "--n", str(n),
             "--engine", "routed", "--alpha", str(ALPHA)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        cli_s = time.perf_counter() - t0
        rows = 0
        total = 0.0
        if proc.returncode == 0:
            out = np.loadtxt(Path(d) / "sparse-scores.csv", delimiter=",",
                             skiprows=1)
            rows = len(out)
            total = float(out[:, 1].sum())
        emit("cli", peers=n, edges=len(src), rc=proc.returncode,
             wall_s=cli_s, stdout=proc.stdout.strip()[-300:],
             stderr=proc.stderr.strip()[-600:], rows=rows, score_sum=total)
        check(proc.returncode == 0, "CLI sparse-scores failed")
        check(rows == n and abs(total - n * 1000.0) / (n * 1000.0) < 1e-3,
              "CLI output CSV wrong")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import protocol_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])
    t_start = time.perf_counter()
    try:
        phase_build()
        max_err = phase_kernel_vs_plain(device)
        times = phase_kernel_times(device)
        launches = phase_main_path(device)
        phase_entry(device)
        phase_cli()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    edge = times[262_144]
    print(json.dumps({"kernels": [{
        "name": "lane_perm",
        "route": "cuda",
        "source": "protocol_tpu_torch/csrc/lane_perm.cu",
        "replaces": "protocol_tpu/ops/clos.py:329",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": edge["ms"],
        "plain_ms": edge["plain_ms"],
        "bound_ms": edge["bound_ms"],
        "bound_by": "bytes",
        "library_ms": edge["library_ms"],
    }]}), flush=True)
    emit("done", wall_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
