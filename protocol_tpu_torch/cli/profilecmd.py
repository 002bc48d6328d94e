"""The ``profile`` CLI verb on torch: run a workload under the instrument
layer and print a merged per-stage report.

The port of ``protocol_tpu/cli/profilecmd.py``: ``prove`` (keygen and
one or more proofs of a synthetic circuit through ``prove_auto``, rounds
3–4 on ``--device``, with the stage coverage check) and ``refresh`` (a
synthetic trust-graph converge through a backend) on the verb, and the
library functions
``run_delta_workload`` and ``run_sublinear_workload`` (the churn path:
one routed build, a ``DeltaEngine`` anchor, churn windows, the refresh
ladder), ``run_scenario_workload`` (a sybil ring under both
semirings), ``run_commits_workload`` (the commit engine's batched
flushes against its serial oracle, through the device MSM under
``PTPU_MSM_DEVICE=1``) and the pool's ``run_proofs_workload``,
``run_sharded_workload`` and ``run_fabric_workload`` (host proves
through the proof pool, its worker lending and the cross-process
fabric, each byte-equal to the direct prove), which the reference's CLI
does not expose either;
``daemon`` submits a ``profile`` capture job to a live ``serve`` daemon
(``--url``) and reports its result.

The run takes sync-span mode by default (``trace.sync_spans()``), so a
span ends only when the card has finished its work; ``--xprof DIR``
captures a ``torch.profiler`` timeline into DIR (``trace.device_trace``).
Report keys are the reference's, so a report from either package reads
the same; its ``compile`` block reads zero compiles (torch runs
eagerly).
"""

from __future__ import annotations

import contextlib
import json
import random
import sys
import time

from ..utils.errors import EigenError


def synthetic_circuit(gates: int = 64, lookup_bits: int = 6,
                      seed: int = 7, public_input: int = 12345,
                      lookup_row: bool = False):
    """The reference's tiny-circuit generator (its ``profile`` verb and
    perf gate build circuits here): ``gates`` multiply-add rows and,
    with ``lookup_row``, one copy-constrained lookup usage."""
    from ..utils.fields import BN254_FR_MODULUS as R
    from ..zk.plonk import ConstraintSystem

    rng = random.Random(seed)
    cs = ConstraintSystem(lookup_bits=lookup_bits)
    for _ in range(gates):
        a, b = rng.randrange(50), rng.randrange(50)
        cs.add_row([a, b, (a * b + a) % R], q_a=1, q_mul_ab=1, q_c=R - 1)
    if lookup_row:
        lk = cs.lookup_row(37)
        row = cs.add_row([37], q_a=1, q_const=R - 37)
        cs.copy(lk, (0, row))
    cs.public_input(public_input)
    cs.check_satisfied()
    return cs


def run_prove_workload(k: int = 7, gates: int = 64, repeat: int = 1,
                       seed: int = 7, device=None) -> dict:
    """Keygen + prove a synthetic circuit on a 2^k domain through
    ``prove_auto`` on ``device`` (the card by default — raises without
    one; ``cpu``: the host path). Both paths are stage-attributed.
    Returns workload metadata; timings land in the process tracer."""
    from ..device import resolve_device
    from ..native import prover as native
    from ..zk import prover_fast as pf
    from ..zk.plonk import verify

    dev = resolve_device(device)
    if not native.available():
        raise EigenError("config_error",
                         "the prove workload needs the native toolchain")
    cs = synthetic_circuit(gates=gates, seed=seed, lookup_row=True)
    params = pf.setup_params_fast(k, seed=b"profile")
    pk = pf.keygen_fast(params, cs, k=k, eval_pk="auto")
    proof = b""
    for _ in range(max(1, repeat)):
        proof = pf.prove_auto(params, pk, cs, device=dev)
    if not verify(params, pk, cs.public_values(), proof):
        raise EigenError("verification_error",
                         "profile workload produced an invalid proof")
    return {"workload": "prove", "k": k, "gates": gates,
            "repeat": repeat, "rows": cs.num_rows, "device": str(dev)}


def run_refresh_workload(n: int = 2000, m: int = 4,
                         engine: str = "gather", tol: float = 1e-6,
                         repeat: int = 1, seed: int = 11,
                         device=None) -> dict:
    """Adaptive converge of a synthetic Barabási–Albert trust graph
    through the backend seam (the service's refresh path): exercises
    the operator build, the converge sweeps, and the iteration and
    residual gauges."""
    import numpy as np

    from ..backend import TorchRoutedBackend, TorchSparseBackend
    from ..graph import barabasi_albert_edges

    src, dst, val = barabasi_albert_edges(n, m, seed=seed)
    valid = np.ones(n, dtype=bool)
    backend = (TorchRoutedBackend if engine == "routed"
               else TorchSparseBackend)(device=device)
    iters = delta = None
    for _ in range(max(1, repeat)):
        _, iters, delta = backend.converge_edges(
            n, src, dst, val, valid, 1000.0, 500, tol=tol)
    return {"workload": "refresh", "n": n, "edges": len(src),
            "engine": engine, "iterations": int(iters),
            "residual": float(delta), "repeat": repeat}


def _reject(eng) -> EigenError:
    return EigenError("resource_error", f"delta batch rejected: {eng.stats}")


def run_delta_workload(n: int = 4000, m: int = 4, batches: int = 10,
                       batch_edges: int = 200, seed: int = 17,
                       device=None) -> dict:
    """The write path at churn: one full routed build
    (``routed.plan_build`` span), a DeltaEngine anchor, then
    weight-revision batches absorbed in place (``delta.classify`` /
    ``delta.revise`` / ``delta.structural`` / ``delta.renorm`` spans)
    and one partial refresh over the dirty frontier. Timings land in
    the process tracer."""
    import numpy as np

    from ..graph import barabasi_albert_edges, filter_edges
    from ..incremental import DeltaEngine, partial_refresh, revision_batch
    from ..ops.routed import build_routed_operator

    rng = np.random.default_rng(seed)
    src, dst, val = barabasi_albert_edges(n, m, seed=seed)
    valid = np.ones(n, dtype=bool)
    fsrc, fdst, _, _, _, raw, _ = filter_edges(n, src, dst, val, valid,
                                               return_raw=True)
    cur = raw.copy()
    op = build_routed_operator(n, src, dst, val, valid)
    eng = DeltaEngine.anchor(n, src, dst, val, valid, op, device=device)
    s_pub, iters, delta = eng.converge(
        eng.initial_node_scores(1000.0), 300, 1e-6)
    eng.take_frontier()
    for _ in range(max(1, batches)):
        deltas = revision_batch(rng, fsrc, fdst, cur, batch_edges)
        if not eng.apply_deltas(deltas):
            raise _reject(eng)
    frontier, _ = eng.take_frontier()
    res = partial_refresh(eng, s_pub, frontier, 1e-6, 300,
                          frontier_limit=n)
    return {"workload": "delta", "n": n, "edges": len(fsrc),
            "batches": batches, "batch_edges": batch_edges,
            "tail": len(eng.tail_index),
            "partial_sweeps": None if res is None else res.sweeps}


def run_sublinear_workload(n: int = 3000, m: int = 4, seed: int = 19,
                           device=None) -> dict:
    """The sublinear refresh ladder end to end, stage-attributed: one
    routed build + anchor (``routed.plan_build``), a localized churn
    window served by the device partial sweep (``partial.device`` span;
    ``device_threshold=0`` forces the device rung), a flooded window
    pushed past a tight frontier limit so the partially-observed mode
    serves it (``partial.sampled`` span), and the full-sweep oracle both
    are checked against (``converge.edges``)."""
    import numpy as np

    from ..graph import barabasi_albert_edges, filter_edges
    from ..incremental import DeltaEngine, ladder_refresh, revision_batch
    from ..ops.routed import build_routed_operator

    rng = np.random.default_rng(seed)
    src, dst, val = barabasi_albert_edges(n, m, seed=seed)
    valid = np.ones(n, dtype=bool)
    fsrc, fdst, _, _, _, raw, _ = filter_edges(n, src, dst, val, valid,
                                               return_raw=True)
    cur = raw.copy()
    op = build_routed_operator(n, src, dst, val, valid)
    # alpha: geometric convergence keeps the workload's sweep counts
    # stable across seeds (the stages are timed, not mixing rates)
    eng = DeltaEngine.anchor(n, src, dst, val, valid, op, alpha=0.15,
                             device=device)
    s_pub, iters, delta = eng.converge(
        eng.initial_node_scores(1000.0), 300, 1e-6)
    eng.take_frontier()

    # localized churn -> device partial sweep
    deltas = revision_batch(rng, fsrc, fdst, cur, 20)
    if not eng.apply_deltas(deltas):
        raise _reject(eng)
    frontier, _ = eng.take_frontier()
    res_dev, mode_dev = ladder_refresh(
        eng, s_pub, frontier, 1e-6, 300, n, device_threshold=0,
        sample_budget=n, error_budget=1e-3)
    s_pub = s_pub if res_dev is None else res_dev.scores

    # flooded churn past a tight frontier limit -> sampled mode
    deltas = revision_batch(rng, fsrc, fdst, cur, 400)
    if not eng.apply_deltas(deltas):
        raise _reject(eng)
    frontier, _ = eng.take_frontier()
    res_smp, mode_smp = ladder_refresh(
        eng, s_pub, frontier, 1e-6, 300, max(len(frontier) // 4, 1),
        device_threshold=0, sample_budget=n, error_budget=1e-3)

    # the full-sweep oracle the sublinear modes are measured against
    s_full, it_f, d_f = eng.converge(s_pub, 300, 1e-6)
    return {"workload": "sublinear", "n": n, "edges": len(fsrc),
            "device_mode": mode_dev, "sampled_mode": mode_smp,
            "device_sweeps": None if res_dev is None else res_dev.sweeps,
            "sampled_sweeps": None if res_smp is None else res_smp.sweeps,
            "full_iterations": int(it_f)}


def run_scenario_workload(peers: int = 4000, seed: int = 23,
                          device=None) -> dict:
    """One mid-scale adversarial scenario per semiring, stage-attributed:
    a seeded sybil-ring build converged through the ConvergeBackend seam
    under (+,*) and again under (max,min), each with its attack-free
    baseline control — so the stages are the whole semiring sweep
    surface (``scenario.run`` wrapping the ``converge.edges`` sweeps for
    both algebras)."""
    from ..scenarios import run_scenario

    # alpha matches the scenario harness default: the damped bound
    # keeps iteration counts seed-stable (the stages are timed, not
    # mixing rates), and both semiring runs share one graph build seed
    reports = {
        name: run_scenario("sybil-ring", peers=peers, seed=seed,
                           semiring=name, alpha=0.1, engine="sparse",
                           device=device)
        for name in ("plusmul", "maxplus")
    }
    return {"workload": "scenario", "peers": peers,
            "edges": reports["plusmul"]["edges"],
            "iterations": {name: rep["scores"]["iterations"]
                           for name, rep in reports.items()},
            "capture": {name: rep["robustness"]["attacker_mass_capture"]
                        for name, rep in reports.items()}}


def run_commits_workload(k: int = 13, columns: int = 8,
                         seed: int = 23, device=None) -> dict:
    """The commit engine in isolation at a size where the MSM is the
    cost: one batched flush of ``columns`` Lagrange-basis eval columns
    and one of SRS coefficient columns at 2^k, stage-attributed as
    ``commit.bench_evals`` / ``commit.bench_coeffs`` (batched label
    from the engine). One column of each batch is re-committed through
    the serial oracle and compared, so a fast-but-wrong batch can never
    pass. Under ``PTPU_MSM_DEVICE=1`` the engine
    commits through the device MSM on ``device`` (default: the card)."""
    import random

    import numpy as np

    from ..native import prover as native
    from ..utils.fields import BN254_FR_MODULUS as R
    from ..zk import prover_fast as pf
    from ..zk.commit_engine import CommitEngine

    if not native.available():
        raise EigenError("config_error",
                         "the commits workload needs the native "
                         "toolchain")
    params = pf.setup_params_fast(k, seed=b"commit-bench")
    rng = random.Random(seed)
    n = 1 << k
    blob = np.frombuffer(
        rng.getrandbits(8 * 32 * n * columns).to_bytes(
            32 * n * columns, "little"),
        dtype="<u8").reshape(columns, n, 4).copy()
    blob[:, :, 3] &= (1 << 59) - 1  # keep scalars < R
    eng = CommitEngine(params, msm_device=device)
    with pf._stage("commit.bench_evals", k, "host",
                   labels=eng.stage_labels()):
        for i in range(columns):
            eng.submit_evals(f"col{i}", blob[i])
        eval_pts = eng.flush()
    with pf._stage("commit.bench_coeffs", k, "host",
                   labels=eng.stage_labels()):
        for i in range(columns):
            eng.submit_coeffs(f"col{i}", blob[i])
        coeff_pts = eng.flush()
    if eval_pts[0] != pf._msm_signed(pf.lagrange_limbs(params), blob[0]):
        raise EigenError("resource_error",
                         "batched eval commit diverged from the serial "
                         "oracle")
    if coeff_pts[-1] != pf.commit_limbs(params, blob[-1]):
        raise EigenError("resource_error",
                         "batched coeff commit diverged from the "
                         "serial oracle")
    return {"workload": "commits", "k": k, "columns": columns,
            "batched": eng.batching}


def run_proofs_workload(k: int = 7, gates: int = 64, jobs: int = 6,
                        workers: int = 2, seed: int = 7) -> dict:
    """Real host-path proves through a ``workers``-worker ProofWorkerPool
    (the serve daemon's proof path at pool scale): exercises per-worker
    prover isolation, cache-affinity scheduling and the submit→run
    pipeline. Stage timings land in ``ptpu_prover_stage_seconds`` (with
    worker labels) and the ``service.proof`` spans, where a scheduling
    regression (queue stall, lost wakeup, serialization across workers)
    shows up as wall-time growth."""
    from ..native import prover as native
    from ..service.faults import FaultInjector
    from ..service.pool import ProofWorkerPool
    from ..zk import prover_fast as pf

    if not native.available():
        raise EigenError("config_error",
                         "the proofs workload needs the native toolchain")
    cs = synthetic_circuit(gates=gates, seed=seed)
    params = pf.setup_params_fast(k, seed=b"profile-pool")
    pk = pf.keygen_fast(params, cs, k=k, eval_pk="auto")
    reference = pf.prove_fast(params, pk, cs, randint=lambda: 424242)

    def prove(p):
        return {"proof": pf.prove_fast(
            params, pk, cs, randint=lambda: 424242).hex()}

    pool = ProofWorkerPool(
        {"eigentrust": prove}, capacity=max(jobs, 8), workers=workers,
        faults=FaultInjector({"rpc": 0.0, "device": 0.0, "disk": 0.0}),
        worker_env=lambda w: pf.worker_isolation(w.name, w.device))
    pool.start()
    submitted = [pool.submit("eigentrust", {}) for _ in range(jobs)]
    deadline = time.monotonic() + 300.0
    while pool.completed + pool.failed < jobs:
        if time.monotonic() > deadline:
            raise EigenError("resource_error", "proof pool stalled")
        time.sleep(0.01)
    for job in submitted:
        got = pool.get(job.job_id)
        if got.status != "done" or \
                bytes.fromhex(got.result["proof"]) != reference:
            raise EigenError(
                "verification_error",
                f"pool proof diverged from the single-worker output "
                f"({got.status}: {got.error})")
    status = pool.pool_status()
    pool.drain(10.0)
    return {"workload": "proofs", "k": k, "gates": gates, "jobs": jobs,
            "workers": workers,
            "per_worker": {w["worker"]: w["jobs_run"]
                           for w in status["workers"]}}


def run_sharded_workload(k: int = 7, gates: int = 64, workers: int = 2,
                         jobs: int = 3, seed: int = 9) -> dict:
    """Real host-path proves SHARDED across a 2-worker pool (worker
    lending, ``pool.shard_kinds``): each prove's commit columns,
    quotient row chunks and opening folds fan out to the idle worker
    and rendezvous in submission order. Byte parity vs the direct
    single-worker prove is asserted per job, and the run must have
    actually sharded (``ptpu_prove_shards_total`` > 0) — a fan-out
    regression that silently serializes would otherwise still pass.
    The ``service.proof`` and ``prove.shard`` spans time it (the shard
    counter counts only while the tracer is enabled)."""
    from ..native import prover as native
    from ..service.faults import FaultInjector
    from ..service.pool import ProofWorkerPool
    from ..utils import trace
    from ..zk import prover_fast as pf

    if not native.available():
        raise EigenError("config_error",
                         "the sharded workload needs the native "
                         "toolchain")
    cs = synthetic_circuit(gates=gates, seed=seed)
    params = pf.setup_params_fast(k, seed=b"profile-shard")
    pk = pf.keygen_fast(params, cs, k=k, eval_pk="auto")
    reference = pf.prove_fast(params, pk, cs, randint=lambda: 424242)
    shards0 = trace.counter_total("prove_shards")

    def prove(p):
        return {"proof": pf.prove_fast(
            params, pk, cs, randint=lambda: 424242).hex()}

    pool = ProofWorkerPool(
        {"eigentrust": prove}, capacity=max(jobs, 8), workers=workers,
        faults=FaultInjector({"rpc": 0.0, "device": 0.0, "disk": 0.0}),
        shard_kinds={"eigentrust"}, shard_cap=4,
        worker_env=lambda w: pf.worker_isolation(w.name, w.device))
    pool.start()
    submitted = [pool.submit("eigentrust", {}) for _ in range(jobs)]
    deadline = time.monotonic() + 300.0
    while pool.completed + pool.failed < jobs:
        if time.monotonic() > deadline:
            raise EigenError("resource_error", "sharded pool stalled")
        time.sleep(0.01)
    for job in submitted:
        got = pool.get(job.job_id)
        if got.status != "done" or \
                bytes.fromhex(got.result["proof"]) != reference:
            raise EigenError(
                "verification_error",
                f"sharded proof diverged from the direct prove "
                f"({got.status}: {got.error})")
    shards = trace.counter_total("prove_shards") - shards0
    if shards <= 0:
        raise EigenError("resource_error",
                         "sharding never engaged (0 shard units)")
    status = pool.pool_status()
    pool.drain(10.0)
    return {"workload": "sharded", "k": k, "gates": gates,
            "jobs": jobs, "workers": workers, "shards": int(shards),
            "lent": {w["worker"]: w["shards_run"]
                     for w in status["workers"]}}


def run_fabric_workload(k: int = 7, gates: int = 64, jobs: int = 3,
                        seed: int = 9) -> dict:
    """Real host-path proves sharded across the CROSS-PROCESS fabric
    (``zk/fabric.py``): a 1-worker pool publishes portable units to a
    throwaway FabricStore and an external worker loop (in-thread here,
    so the run times the serialization and rendezvous, not a process
    spawn) claims, executes and returns them. Byte parity vs
    the direct prove is asserted per job, and at least one unit must
    have been applied from the fabric (``ptpu_fabric_units_total`` > 0)
    — a publish/claim regression that silently degrades to all-local
    would otherwise still pass. The ``service.proof``, ``prove.shard``
    and ``fabric.unit`` spans time it (the unit counter counts only
    while the tracer is enabled); the worker is the port's
    ``run_worker``, whose heartbeat thread keeps its own name."""
    import shutil
    import tempfile
    import threading

    from ..native import prover as native
    from ..service.faults import FaultInjector
    from ..service.pool import ProofWorkerPool
    from ..utils import trace
    from ..zk import prover_fast as pf
    from ..zk.fabric import FabricStore, run_worker

    if not native.available():
        raise EigenError("config_error",
                         "the fabric workload needs the native "
                         "toolchain")
    cs = synthetic_circuit(gates=gates, seed=seed)
    params = pf.setup_params_fast(k, seed=b"profile-shard")
    pk = pf.keygen_fast(params, cs, k=k, eval_pk="auto")
    reference = pf.prove_fast(params, pk, cs, randint=lambda: 424242)
    units0 = trace.counter_total("fabric_units")

    def prove(p):
        return {"proof": pf.prove_fast(
            params, pk, cs, randint=lambda: 424242).hex()}

    root = tempfile.mkdtemp(prefix="ptpu-fabric-")
    fabric = FabricStore(root, lease_ttl=5.0)
    pool = ProofWorkerPool(
        {"eigentrust": prove}, capacity=max(jobs, 8), workers=1,
        faults=FaultInjector({"rpc": 0.0, "device": 0.0, "disk": 0.0}),
        shard_kinds={"eigentrust"}, shard_cap=4,
        worker_env=lambda w: pf.worker_isolation(w.name, w.device),
        fabric=fabric)
    pool.start()
    stop = threading.Event()
    worker = threading.Thread(
        target=run_worker, args=(fabric, "fw-gate"),
        kwargs={"poll": 0.01, "stop": stop},
        name="ptpu-profile-worker", daemon=True)
    worker.start()
    try:
        deadline = time.monotonic() + 60.0
        while fabric.workers_live() < 1:
            fabric._workers_cache = (0.0, 0)
            if time.monotonic() > deadline:
                raise EigenError("read_write_error",
                                 "fabric worker never registered")
            time.sleep(0.01)
        submitted = [pool.submit("eigentrust", {}) for _ in range(jobs)]
        deadline = time.monotonic() + 300.0
        while pool.completed + pool.failed < jobs:
            if time.monotonic() > deadline:
                raise EigenError("resource_error", "fabric pool stalled")
            time.sleep(0.01)
        for job in submitted:
            got = pool.get(job.job_id)
            if got.status != "done" or \
                    bytes.fromhex(got.result["proof"]) != reference:
                raise EigenError(
                    "verification_error",
                    f"fabric proof diverged from the direct prove "
                    f"({got.status}: {got.error})")
        units = trace.counter_total("fabric_units") - units0
        if units <= 0:
            raise EigenError("verification_error",
                             "the fabric never engaged (0 units "
                             "applied from the external worker)")
    finally:
        stop.set()
        worker.join(timeout=10.0)
        pool.drain(10.0)
        shutil.rmtree(root, ignore_errors=True)
    return {"workload": "fabric", "k": k, "gates": gates,
            "jobs": jobs, "units": int(units)}


# --- report ----------------------------------------------------------------

def fold_prover_stages() -> dict:
    """``ptpu_prover_stage_seconds`` series folded per stage label:
    ``{stage: {count, total_s}}``."""
    from ..utils import trace

    stages: dict = {}
    for items, s in trace.histogram("prover_stage_seconds").series():
        labels = dict(items)
        key = labels.get("stage", "?")
        entry = stages.setdefault(key, {"count": 0, "total_s": 0.0})
        entry["count"] += s["count"]
        entry["total_s"] += s["sum"]
    return stages


def collect_stage_report(meta: dict, total_wall: float) -> dict:
    """Merge the tracer's per-stage instruments into one report dict:
    prover stages, the prove/converge totals, the converge sweep means,
    and compile stats. ``coverage`` is sum(stage seconds)/prove total."""
    from ..utils import trace

    stages = fold_prover_stages()
    prove_total = 0.0
    for _, s in trace.histogram("prover_total_seconds").series():
        prove_total += s["sum"]
    converge = {}
    for name in ("converge.edges", "routed.plan_build",
                 "service.operator_build"):
        agg = trace.summary().get(name)
        if agg:
            converge[name] = {"count": agg["count"],
                              "total_s": round(agg["total_s"], 6)}
    sweep = {}
    for items, s in trace.histogram("converge_sweep_seconds").series():
        labels = dict(items)
        sweep[labels.get("backend", "?")] = {
            "sweeps": s["count"],
            "mean_sweep_s": (s["sum"] / s["count"]) if s["count"] else 0.0,
        }
    stage_total = sum(e["total_s"] for e in stages.values())
    coverage = (stage_total / prove_total) if prove_total > 0 else None
    return {
        "schema": "ptpu-profile-v1",
        "meta": meta,
        "total_wall_s": round(total_wall, 6),
        "prove_total_s": round(prove_total, 6),
        "stages": {k: {"count": v["count"],
                       "total_s": round(v["total_s"], 6)}
                   for k, v in sorted(stages.items())},
        "stage_total_s": round(stage_total, 6),
        "coverage": round(coverage, 4) if coverage is not None else None,
        "converge": converge,
        "sweep": sweep,
        "compile": trace.compile_stats(),
        "sync_spans": trace.sync_enabled(),
    }


def print_report(report: dict, out=None) -> None:
    # resolve stdout at CALL time (a def-time default would capture a
    # test harness's swapped-out stream)
    out = out if out is not None else sys.stdout
    meta = report["meta"]
    print(f"profile: workload={meta.get('workload')} "
          f"wall={report['total_wall_s']:.3f}s "
          f"sync_spans={report['sync_spans']}", file=out)
    if report["stages"]:
        width = max(len(s) for s in report["stages"])
        denom = report["prove_total_s"] or report["total_wall_s"]
        print(f"{'stage':<{width}}  {'n':>5}  {'total_s':>9}  "
              f"{'share':>6}", file=out)
        for name, e in sorted(report["stages"].items(),
                              key=lambda kv: -kv[1]["total_s"]):
            share = e["total_s"] / denom if denom else 0.0
            print(f"{name:<{width}}  {e['count']:>5}  "
                  f"{e['total_s']:>9.3f}  {share:>5.1%}", file=out)
        print(f"prove total {report['prove_total_s']:.3f}s, stage sum "
              f"{report['stage_total_s']:.3f}s", file=out)
    for name, e in report["converge"].items():
        print(f"{name}: n={e['count']} total={e['total_s']:.3f}s",
              file=out)
    for backend, e in report["sweep"].items():
        print(f"converge sweeps[{backend}]: {e['sweeps']} observed, "
              f"mean {e['mean_sweep_s'] * 1000:.3f}ms", file=out)
    c = report["compile"]
    print(f"compile: {c['compiles']} compile(s), "
          f"{c['compile_seconds']:.3f}s compiling (torch runs eagerly)",
          file=out)
    if report["coverage"] is not None:
        print(f"STAGE_COVERAGE={report['coverage']:.4f}", file=out)


def run_daemon_capture(url: str, seconds: float) -> dict:
    """Submit a ``profile`` job to a live daemon and wait for the
    capture window to close; returns the job result (the ``torch.profiler`` log dir on
    the daemon's filesystem)."""
    import urllib.error
    import urllib.request

    def call(method, path, body=None):
        req = urllib.request.Request(
            url.rstrip("/") + path, method=method,
            data=(json.dumps(body).encode() if body is not None
                  else None),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            # 429 = queue backpressure, 503 = draining — structured
            # errors, not tracebacks
            raise EigenError(
                "service_busy",
                f"daemon rejected {method} {path}: HTTP {e.code} "
                f"{e.read()[:200].decode(errors='replace')}") from e
        except urllib.error.URLError as e:
            raise EigenError(
                "connection_error",
                f"cannot reach daemon at {url}: {e.reason}") from e

    job = call("POST", "/proofs",
               {"kind": "profile", "params": {"seconds": seconds}})
    job_id = job["job_id"]
    deadline = time.monotonic() + seconds + 120.0
    while time.monotonic() < deadline:
        job = call("GET", f"/proofs/{job_id}")
        if job["status"] in ("done", "failed", "cancelled"):
            break
        time.sleep(min(1.0, seconds / 4 + 0.2))
    if job["status"] != "done":
        raise EigenError(
            "service_busy",
            f"daemon capture job {job_id} ended {job['status']}: "
            f"{job.get('error')}")
    return {"workload": "daemon", "url": url, "job_id": job_id,
            **(job.get("result") or {})}


def handle_profile(args) -> int:
    """Run the chosen workload under sync-span tracing (+ optional
    ``torch.profiler`` capture) and print/write the merged per-stage
    report."""
    from ..utils import trace

    if args.jsonl or not trace.TRACER.enabled:
        # enable() closes any previously-opened stream before swapping
        trace.enable(args.jsonl)
    trace.sync_spans(not args.no_sync)
    trace.install_compile_tracking()
    trace_id = f"profile-{trace.new_id()}"

    if args.workload == "daemon":
        # the capture runs on the daemon's side (its log dir comes back
        # in the job result); a local capture would time an HTTP loop
        if not args.url:
            raise EigenError("config_error",
                             "--workload daemon needs --url (a live "
                             "serve daemon)")
        if args.xprof:
            print("note: --workload daemon captures on the daemon's "
                  "filesystem (log_dir in the report); local --xprof "
                  "ignored", file=sys.stderr)
        args.xprof = None
    capture = (trace.device_trace(args.xprof) if args.xprof
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with trace.context(trace_id=trace_id), capture:
        if args.workload == "daemon":
            meta = run_daemon_capture(args.url, args.seconds)
        elif args.workload == "prove":
            meta = run_prove_workload(k=args.k, gates=args.gates,
                                      repeat=args.repeat,
                                      device=args.device)
        else:
            meta = run_refresh_workload(
                n=args.n, m=args.edges_per_node, engine=args.engine,
                tol=args.tol, repeat=args.repeat, device=args.device)
    total_wall = time.perf_counter() - t0
    meta["trace_id"] = trace_id
    if args.xprof:
        meta["xprof"] = args.xprof

    report = collect_stage_report(meta, total_wall)
    print_report(report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    if args.min_coverage:
        if report["coverage"] is None:
            print("error: --min-coverage needs a prove workload "
                  "(no prover total recorded)", file=sys.stderr)
            return 1
        if report["coverage"] < args.min_coverage:
            print(f"error: stage coverage {report['coverage']:.4f} < "
                  f"{args.min_coverage}", file=sys.stderr)
            return 1
    return 0
