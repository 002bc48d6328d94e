#!/usr/bin/env python3
"""Drive the torch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card. It
builds the port's kernels (nvcc, one process per source) and Clos
planner (g++) from the sources in the checkout; the build phase prints
ptxas's registers and spills for every kernel and fails if one spills
or ``mont_mul`` passes 64 registers. It holds the route-stage kernel
(``csrc/lane_perm.cu``: one Clos route stage, transpose included, in
its forward, middle and reverse forms) bit for bit against its plain
PyTorch version in every form and dtype, on one vector and on a batch
of five sharing one index array, times it by CUDA-graph replay
beside its memory bound, its plain version, one ``torch.gather`` call,
and the parent design (the lane permutation, then a torch transpose),
then runs the Clos-routed EigenTrust converge at 1M peers
(Barabási–Albert, m=8, seed 0, both directions attested: the repo's
converge benchmark graph) through ``TorchRoutedBackend`` and checks it
against the float64 gather path on the same card, its routes against
the plain stages' bit for bit, the ``entry()`` twin against its CPU
run, and the ``sparse-scores`` CLI on a 100K-peer edge list.

On the same operator (no second plan build) run the churn path and the
topic batch. ``delta``: a ``DeltaEngine`` converges cold, absorbs 20
``revision_batch``es of 5,000 edges and 1,000 new edges into its COO
tail with no full build, converges warm on the patched operator (B1 on
every stage) within 1e-3 of a from-scratch float64 gather converge and
within bounds, over all peers and per renormalized row and tail
destination, that the same converge with the tail fold dropped or the
row rescale reset must fail; the refresh ladder serves a localized
window by ``device_partial`` and a flooded one by ``sampled``, each
within its declared L1 budget of the full converge. ``topics``: five
topic vectors through one batched loop, each route stage one launch
for all five (B1's batch axis), bit-exact against single routes and
the plain stages, and within rtol 1e-4 of each topic's own converge;
the batched stage and sweep are timed beside the single ones.

On the same graph runs phase ``sharded``: the device mesh
(``parallel/``) on a virtual mesh of eight repeats of the card, every
shard launching its own kernels. The converge graph is row-sharded
(all-gather of the scores, each shard's gather SpMV) and Clos-routed
(device-major plan, B1 on every shard, the level-0 shuffle as an
all-to-all) for 20 fixed sweeps and an adaptive run, each held against
the single-device gather or routed converge (rtol 1e-4, atol 0.5,
iterations ±1), mass conserved and B1 launched as the layout says; the
sharded builds and sweeps are timed beside the single-device sweeps and
the exchanges alone; ``ntt_sharded`` at 2^20 must equal ``ntt`` bit for
bit. Its times are a virtual mesh's on one card: no scaling claim.
Phase ``sharded_checks`` runs the rest of the slice beside the
host-bound phases (in the MSM child's process, below):
``sparse-scores --checkpoint-dir`` through the CLI on the GPU mesh
``make_mesh()`` gives (a 100K-peer edge list, stopped after one chunk
and resumed, equal to an uninterrupted run), ``sharded_recover_batch``
on the 65,536 ingest lanes bit-identical to ``recover_batch``,
``ShardedRound3`` on a k = 16 ``DeviceProver`` bit-identical in its ext
chunks, quotient chunks and 4n inverse, and ``dryrun_multichip`` on
both meshes.

The second path is batched attestation ingest on the field kernels
(``csrc/field.cu``: the Montgomery multiply that replaces the TPU's
``_mont_mul_kernel``, and the modular add and subtract). The script
holds each
kernel against its plain PyTorch version bit for bit (four moduli, n
from 1 to 819,200 around the tile sizes, edge and lazy values, operands
as made, 16-byte-misaligned views and broadcast rows, and Python ints
on sampled lanes), times them by CUDA-graph replay (device time without
the host's pacing) and back to back at 32,768, 262,144 and 819,200
lanes beside their bounds, runs ``field_converge`` at N = 512 against a
host Python-int converge, and ingests 65,536 signed attestations
(1,024 distinct ones by 64 signers, tiled, with forged lanes at known
indices) through ``recover_signers_batch``: every honest lane must
recover its signer, every forged one must not, and the field kernels'
launches per chunk must be the path's.

Two user-facing paths carry the kernels too. ``scenario``: the
adversarial harness's ``scenario run`` verb on a 300,000-peer sybil ring
(seed 7) with ``--engine routed``, once per semiring, each held against
the same run with ``--engine sparse`` (under ``maxplus`` every field
equal but the residual, a float32 sum in another order; under
``plusmul`` iterations within one and mass capture within 1e-4
relative), B1's launches equal to each operator's route stages times
its sweeps. ``scores``: the client flow through the CLI (``deploy``,
four mnemonics ``attest`` each other, ``attestations``, ``scores`` and
``local-scores`` with a torch backend and ``--batched-ingest``, each
equal to the exact path's scores.csv), the port's demo assets through
``local-scores --batched-ingest`` equal to the committed scores.csv, and
the client's auto mode on 48 attestations taking the batched path with
the scalar path's setup; the field kernels' launches there are counted.

The trust-scores daemon carries both kernels (phase ``serve``): a
state dir at 100,000 peers (Barabási–Albert, m = 8, about 1.6M
filtered edges) written as one snapshot by the daemon's own codec,
``TrustService`` built in process as the ``serve`` verb builds it
(``batched_ingest=None``, the default device and thresholds), its
restore and first, cold routed refresh timed (plan build apart), then
1,024 attestations by 64 mnemonic signers in four waves through the
local chain file it tails, each wave's signers recovered on the field
kernels by the sink and its refresh served by the delta engine's
ladder with no full build. Every served score of the signers and of
1,000 seeded peers is held within 1e-3 of a float64 gather converge
over the daemon's edge set, ``/metrics`` to the exposition lint and
``/status`` to its keys; after the drain, ``python -m
protocol_tpu_torch.cli serve`` restarts on the same state dir (its
startup compaction recovers the WAL's signers in batch once more) and
must serve the same scores, with ``store inspect``'s counts equal to
its ``/status``. Before the leader's drain, a follower replica runs
beside it on the card as ``serve --follow`` builds it: it bootstraps
from the leader's seeded snapshot (the leader snapshots only at its
drain), catches up on the four shipped waves (one batched recovery on
the field kernels, the cold routed refresh and the delta engine on
B1: the launches counted there are the follower's alone), absorbs one
live wave with the leader, and must serve scores within 1e-3 of a
float64 gather converge over its own edges and of the leader's, lag 0,
the leader's ``/bundle`` byte for byte (304 on ``If-None-Match``), a
503 on ``POST /proofs`` and one full build; ``fleet``, ``slo`` and
``incident`` run against the pair; then a ``serve --follow`` restart
on its state dir resumes from its cursor with the same scores.

Last comes the EigenTrust proof (phase ``prove``): the device prover
of ``zk/prover_tpu.py`` runs every field product on B2 and every sum on
``add_mod``/``sub_mod``, its NTT's stage products on ``torch._int_mm``.
The NTT (forward, inverse, coset) at 2^10, 2^16 and 2^20 must equal the
host prover core's ``FieldKernel.ntt`` and its float64 plain version,
each timed by graph replay beside its int8-operations bound; a
``DeviceProver`` at k = 16 on seeded fixed and σ columns, in resident,
"fixed" and streaming residency, must give the host core's ext chunks
(plain and blinded), quotient chunks (``quotient_eval2``), 4n inverse
and ζ-evaluations; a synthetic k = 14 circuit proved by
``prove_fast_tpu`` on the card and ``prove_fast`` on the host from one
seeded blinding stream must give the same bytes, and verify. Then the
CLI at the tiny shape (2 peers, 2 iterations, k = 20): the seeded SRS
from ``zk.api.generate_kzg_params`` where ``kzg-params`` writes it (the
verb itself at k = 10), ``et-proving-key``, two mnemonics attesting
each other, ``et-proof`` with rounds 3–4 on the card (device stages in
``ptpu_prover_stage_seconds`` and B2 launches > 0, counted),
``et-verify`` VALID, and INVALID with one proof byte flipped;
``et-verifier --check`` must replay the card's proof VALID in the
in-repo Yul EVM (with its gas) and INVALID with the byte flipped, and
``et-verifier --rpc`` must deploy the verifier to an in-process
``MockNode`` and verify VALID on-chain; and ``profile --workload prove
--k 18`` must cover its prove with its stage times (``--min-coverage``).

Then the Threshold proof (phase ``threshold``), through the CLI's verbs
at their only shape (4 peers, 20 iterations, k = 21): a seeded k = 21
SRS, four mnemonics attesting each other, ``th-proving-key`` (a dummy
inner EigenTrust snark keyed and proved, then the Threshold circuit
that verifies it in-circuit keyed), ``th-proof`` in the same process
(the inner snark and the Threshold circuit, both proved with rounds
3–4 on the card: two device proves and no host prove, B2 and its
companions launched), its ``threshold_check`` equal to the host's
``Client.verify_threshold``, ``th-verify`` VALID (the PLONK verify
plus the deferred KZG decide on the 16 accumulator limbs) and INVALID
with one proof byte flipped.

Last, the proving fabric (phase ``fabric``): a daemon with two pool
workers, ``shard_proves`` and ``fabric`` proves a k = 16 synthetic
circuit on the card per job while ``prove-worker`` polls its state dir
as its own process; each dispatch's first unit is published once that
process holds its lease, and every job after the first runs while a
held job keeps the other pool worker busy (an idle pool worker lends
itself units whatever their lease); up to eight jobs until one has a
unit executed by that process, every job's proof equal to the
unsharded prove's bytes,
the fabric series on ``/metrics``, the worker on ``/fleet`` and a
clean exit on SIGTERM.

The device MSM (phase ``msm``, ``ops/msm_device.py``: the sorted-prefix
Pippenger, every field op on B2, ``add_mod`` and ``sub_mod``) runs at
full width (c = 4, 66 windows) over 2^16 and 2^20 bases of a seeded SRS
with seeded scalars below R: each point equal to the host's
``g1_msm_multi`` on the same bases and scalars, the field launches of
each MSM equal to the count the code gives (``launch_counts``), P and
−P cancelling to the identity; it prints the host prep, the device
seconds, the host MSM's seconds, peak device memory and one group-law
add's device and host time. In phase ``msm_commits``,
``run_commits_workload`` at k = 13 with 8 columns runs on the host and
under ``PTPU_MSM_DEVICE=1`` (each with its own oracle check, the card's
launches those of 16 full-width MSMs), and a k = 12 lockstep proves on
the card with its commits through the device MSM, byte-equal to the
host prove and verifying; then the profile library's pool workloads
(``proofs``, ``sharded``, ``fabric``) run at their defaults, each with
its own byte-parity checks.

The phases that time a kernel (through ``sharded``, ``prove``'s NTT,
``DeviceProver`` and lockstep pieces, and ``msm``) run first and alone
on the card. Two
processes of their own then run beside the phases from ``scenario`` to
``fabric``, which time no kernel: phase ``threshold``, host-bound for
most of its wall (``chip_smoke.py --threshold-child``), and phases
``msm_commits``, ``workloads`` and ``sharded_checks``, paced by the
host's launches (``--msm-child``); each child's launch counts are its
own, and the run joins both last.

Every phase prints one JSON line, with the run's elapsed seconds
(``t_s``) and a progress line on stderr; any failed check exits
non-zero. Every wait is cut at SMOKE_DEADLINE_S, so a stalled wait fails
with its name within the 1,200 s limit, and at DUMP_AFTER_S every
thread's stack goes to stderr. The last lines are the ``kernels`` record, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. With no CUDA device, or outside
the repository, it exits non-zero and prints no result. Imports nothing
of JAX or of ``protocol_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import random
import re
import shutil
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
# the churn path (phase delta): the serve smoke's churn evidence at the
# scale README.md documents, 20 revision batches = 100,000 revised edges
DELTA_SEED = 7
DELTA_BATCHES = 20
DELTA_BATCH_EDGES = 5000
DELTA_INSERTS = 1000           # one structural batch into the COO tail
DELTA_PARITY = 1e-3            # max relative diff vs a rebuild (serve smoke)
# the churn window's bounds against the same rebuild, about 30 times what
# the H100 gives (5.9e-7 and 8.9e-6): relative L1 over all peers, and the
# largest relative difference of one peer among the renormalized rows and
# the tail edges' destinations. The engine's state with its tail fold
# dropped or its row rescale reset gives 5e-3 / 0.09 or more.
DELTA_REL_L1 = 2e-5
DELTA_MAX_REL_TOUCHED = 3e-4
LADDER_LOCAL = 20              # revisions of the localized window
LADDER_FLOOD = 5000            # revisions of the flooded window
LADDER_ERROR_BUDGET = 1e-3     # relative L1 (the sublinear workload's)
TOPICS = 5                     # topic vectors per batch (the reference test)
# phase sharded: the device mesh on SHARDED_D repeats of the card (the
# reference's virtual mesh is 8 CPU devices)
SHARDED_D = 8
SHARDED_FIXED_SWEEPS = 20      # the reference-parity fixed run
SHARDED_CHECKPOINT_EVERY = 10  # sweeps per chunk of the CLI's runs
SHARDED_NTT_K = 20
SHARDED_R3_K = 16              # phase prove's DeviceProver; k = 20 is cut

# 32-bit integer multiply-adds per clock per SM on compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
INT_MULADD_PER_CLK_PER_SM = 64
# around one 64-row tile of the field kernels and two, an ingest chunk,
# N = 512's products and the Poseidon MDS step
FIELD_SIZES = (1, 63, 64, 65, 127, 128, 129, 32_768, 262_144, 819_200)
FIELD_SAMPLE = 1000            # lanes per case checked against Python ints
# (lanes, launches per CUDA graph) of the field kernels' device times: one
# row (a launch's fixed cost), an ingest chunk, N = 512's products and
# the Poseidon MDS step
FIELD_TIME_SIZES = ((1, 400), (32_768, 400), (262_144, 100), (819_200, 40))
# input bytes a timed graph cycles through: five times the H100's 50 MB
# L2, so every launch reads its operands from device memory
COLD_BYTES = 256 << 20
FIELD_MAX_REGISTERS = 64       # mont_mul's budget, with no spills
# field-kernel launches per 32,768-lane ingest chunk (hash and recovery)
FIELD_LAUNCHES_PER_CHUNK = {"mont_mul": 5449, "add_mod": 2568,
                            "sub_mod": 2110}
CONVERGE_N = 512               # the largest set mont_matvec takes for Fr
CONVERGE_ITERATIONS = 20       # the client's converge iterations
# 2 chunks of the service's 32,768: cut from 8 chunks (262,144) to keep
# the smoke, phase threshold included, inside its time limit; every
# per-chunk check runs on each chunk
INGEST_ATTESTATIONS = 65_536
INGEST_CHUNK = 32_768
INGEST_DISTINCT = 1024
INGEST_SIGNERS = 64
# the client flow (phase scores): four mnemonics rate each other through
# the CLI; the auto mode's setup takes 48 attestations among them
SCORES_MNEMONICS = (
    "test test test test test test test test test test test junk",
    "legal winner thank year wave sausage worth useful legal winner thank "
    "yellow",
    "letter advice cage absurd amount doctor acoustic avoid letter advice "
    "cage above",
    "abandon abandon abandon abandon abandon abandon abandon abandon "
    "abandon abandon abandon about")
AUTO_ATTESTATIONS = 48
# the adversarial harness (phase scenario): a sybil ring under both
# semirings, cut from the largest size bench.py's scenario cells name
# (1M peers) to keep the smoke, phase threshold included, inside its
# time limit
SCENARIO_PEERS = 300_000
SCENARIO_SEED = 7
SCENARIO_CAPTURE_RTOL = 1e-4


# the trust-scores daemon (phase serve): 100,000 peers (the reference's
# service evidence is stated at 100k edges and up), BA m = 8 (about 1.6M
# filtered edges, 16x the routed threshold), 64 mnemonic signers posting
# 1,024 attestations in four waves (three revisions of edges in the
# snapshot and one new edge per signer and wave), then a restart
# through the CLI on the same state dir
SERVE_PEERS = 100_000
SERVE_SEED = 11
SERVE_SIGNERS = 64
SERVE_WAVES = 4
SERVE_REVISIONS = 3            # per signer and wave, plus one new edge
SERVE_CHECKED = 1000           # seeded peers whose served score is held
# |served - reference| <= rtol * max(|reference|, 1): the reference serve
# smoke's bound against its oracle, and its restart phase's
SERVE_SCORE_RTOL = 1e-3
SERVE_RESTART_RTOL = 1e-3
SERVE_TIMEOUT_S = 300.0        # any one wait of the phase
# the leader snapshots only at its drain (the seeded snapshot before),
# so the follower, started after the four waves, bootstraps from the
# seeded cut and catches up on all 1,024 shipped records; then one live
# wave of SERVE_SIGNERS * (SERVE_REVISIONS + 1) attestations reaches both
SERVE_LEADER_SNAPSHOT_EVERY = 1 << 30
SERVE_LIVE_WAVES = 1

# phase fabric: a daemon with two pool workers lends a running prove's
# commit units to them and, through <state-dir>/fabric, to an external
# prove-worker process; each job proves a synthetic circuit at
# FABRIC_K on the card (the daemon's k = 20 tiny shape is 16 times the
# rows, PERF.md section 4) from a seeded blinding stream, so every
# job's bytes equal one unsharded prove's
FABRIC_K = 16
FABRIC_SEED = 16
FABRIC_MAX_JOBS = 8
FABRIC_JOB_TIMEOUT_S = 120.0   # one job proves in about 5 s on the card
FABRIC_WORKER = "fw-smoke"

# the proof path (phase prove): the NTT at three sizes (a test-sized
# domain, the k = 16 prover's, the k = 20 prover's), the DeviceProver's
# pieces at k = 16, a synthetic circuit proved on the card and on the
# host at k = 14, the CLI's EigenTrust proof at the tiny shape (2 peers,
# 2 iterations: 790k rows, k = 20; zk/api.py TINY_SHAPE and the
# reference CLI's --shape tiny), and the profile verb's stage coverage
# of a k = 18 prove
PROVE_NTT_KS = (10, 16, 20)
PROVE_DP_K = 16
PROVE_LOCKSTEP_K = 14
PROVE_PROFILE_K = 18
PROVE_MIN_COVERAGE = 0.95
PROVE_SRS_SEED = b"chip-smoke-srs"
PROVE_MNEMONICS = SCORES_MNEMONICS[:2]  # the tiny shape holds 2 peers
# phase msm: full-width device MSMs (c = 4, 66 windows) over a seeded
# SRS, held against the host's all-core MSM
MSM_SIZES = (1 << 16, 1 << 20)
MSM_C = 4
MSM_SRS_SEED = b"chip-smoke-msm-srs"
MSM_SCALAR_SEED = 41
MSM_ADD_LANES = ((1, 20), (1 << 16, 5), (1 << 20, 3))  # (lanes, launches)
# beside the threshold process: the commits workload with and without
# PTPU_MSM_DEVICE=1, and a lockstep prove committing on the card
COMMITS_K = 13
COMMITS_COLUMNS = 8
MSM_LOCKSTEP_K = 12
# phase threshold: the CLI's only Threshold shape (4 peers, 20
# iterations, both proves at TH_PARAMS_K = 21) on a seeded SRS
TH_SRS_SEED = b"chip-smoke-th-srs"
TH_PEER = 2                    # the participant whose score is checked
TH_THRESHOLD = 500             # under every score of the four-peer ring
# H100 SXM dense int8 tensor-core rate (data sheet): the NTT's bound
INT8_OPS_PER_S = 1979e12


# the whole run must end within 1,200 s: every wait is cut to what is
# left before this deadline, so a stalled wait fails with its name
# instead of running into the limit, and at DUMP_AFTER_S every thread's
# stack goes to stderr (a stall outside a wait shows where it is)
SMOKE_DEADLINE_S = 1140.0
DUMP_AFTER_S = 1160.0
_T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def _left(timeout: float) -> float:
    """``timeout``, cut to the seconds left before SMOKE_DEADLINE_S."""
    return max(0.0, min(timeout,
                        SMOKE_DEADLINE_S - (time.perf_counter() - _T0)))


def emit(phase: str, **fields) -> None:
    """One JSON line on stdout; ``t_s`` is the run's elapsed wall, and a
    line on stderr says how far the run got."""
    t = time.perf_counter() - _T0
    print(json.dumps({"phase": phase, **fields, "t_s": t}), flush=True)
    print(f"chip_smoke: {t:.1f} s: {phase}", file=sys.stderr, flush=True)


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


def device_busy(fn) -> tuple:
    """``fn()`` under the profiler: its result, the summed duration of
    the CUDA kernels and copies it ran (ms; one stream, so they do not
    overlap) and their count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    return out, sum(us) / 1e3, len(us)


def graph_ms(fn, launches: int, replays: int = 5,
             profiled: bool = False) -> dict:
    """Device time of one call of ``fn`` without the host's pacing:
    ``fn(i)`` for i in range(launches) captured in one CUDA graph, the
    median of ``replays`` replays divided by ``launches`` (``ms``). The
    graph keeps every call's result, so each launch writes memory of its
    own; an ``fn`` whose inputs cycle through more than the L2 holds is
    timed from device memory, not from the cache. ``profiled`` adds the
    profiler's view of one more replay: the mean duration of its kernels
    (``kernel_ms``, without the gaps between launches) and their count."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        results = [fn(i) for i in range(launches)]
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / launches)
    out = {"ms": sorted(times)[replays // 2]}
    if profiled:
        _, busy_ms, events = device_busy(graph.replay)
        out["kernel_ms"] = busy_ms / events if events else None
        out["kernel_events"] = events
    del results, graph
    return out


_FORMS = ("forward", "middle", "reverse")
_CTYPES = {"f": "float32", "d": "float64", "i": "int32"}


def _kernel_name(mangled: str) -> str:
    """A readable name for a kernel of field.cu or lane_perm.cu."""
    m = re.search(r"route_stage_kernelI([fdi])Li(\d)ELb([01])E", mangled)
    if m:
        batch = "_batch" if m[3] == "1" else ""
        return f"route_stage_{_FORMS[int(m[2])]}_{_CTYPES[m[1]]}{batch}"
    for key, name in (("mont_mul_kernel", "mont_mul"),
                      ("add_sub_kernelILi1E", "add_mod"),
                      ("add_sub_kernelILi2E", "sub_mod")):
        if key in mangled:
            return name
    return mangled


def ptxas_usage(log: str) -> dict:
    """Registers, spill bytes and shared memory of each kernel, from the
    ``-Xptxas -v`` messages of a build."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
            usage[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                usage[name]["spill_bytes"] = int(m[1]) + int(m[2])
            m = re.search(r"Used (\d+) registers", line)
            if m:
                usage[name]["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                usage[name]["smem_bytes"] = int(m[1])
    return usage


def phase_build() -> None:
    from protocol_tpu_torch import native
    from protocol_tpu_torch._build import build_log
    from protocol_tpu_torch.native import prover as prover_native
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.ops.kernels import lane_perm_kernel as lp

    def timed(fn):
        t0 = time.perf_counter()
        path = fn()
        return time.perf_counter() - t0, str(path.relative_to(ROOT))

    # one compiler per source, started together
    with ThreadPoolExecutor(max_workers=4) as pool:
        nv = pool.submit(timed, lp.build)
        nf = pool.submit(timed, fk.build)
        gx = pool.submit(timed, native.build)
        gp = pool.submit(timed, prover_native.build)
        ((nvcc_s, nvcc_lib), (field_s, field_lib), (gxx_s, gxx_lib),
         (prover_s, prover_lib)) = (nv.result(), nf.result(), gx.result(),
                                    gp.result())
    check(native.available(), "native planner did not load")
    check(prover_native.available(), "the prover core did not load")
    usage = {}
    for lib in (nvcc_lib, field_lib):
        usage.update(ptxas_usage(build_log(ROOT / lib)))
    emit("build", nvcc_s=nvcc_s, nvcc_lib=nvcc_lib, field_nvcc_s=field_s,
         field_lib=field_lib, gxx_s=gxx_s, gxx_lib=gxx_lib,
         prover_gxx_s=prover_s, prover_lib=prover_lib, usage=usage)
    check(len(usage) == 21, f"ptxas reported {sorted(usage)}, not the "
          "18 route-stage kernels (three forms, three dtypes, one vector "
          "or a batch) and the three field kernels")
    spills = {k: u for k, u in usage.items() if u.get("spill_bytes") != 0}
    check(not spills, f"kernels spill: {spills}")
    mm = usage.get("mont_mul", {})
    check(mm.get("registers", FIELD_MAX_REGISTERS + 1) <= FIELD_MAX_REGISTERS,
          f"mont_mul uses {mm} (budget {FIELD_MAX_REGISTERS} registers)")


# (m, B) of the route-stage kernel's transposing forms checked on the
# card: small m (below, at and past a tile's 16 or 32 rows) with one and
# three subproblems (a ragged last tile), and every (m, B) of the 1M-peer
# routes: the edge route's three levels at T = 262,144, the state
# route's two at 8,192
ROUTE_STAGE_CASES = ((2, 1), (2, 3), (16, 1), (16, 3), (64, 1), (64, 3),
                     (8192, 1), (8192, 3), (1 << 18, 1), (1 << 11, 128),
                     (16, 1 << 14), (64, 128))
# (m, B) of the topic batch [TOPICS, T, 128] checked on the card: a ragged
# tile and every (m, B) of the 1M-peer routes, the stages the topic
# converge runs
BATCHED_STAGE_CASES = ((16, 3), (1 << 18, 1), (1 << 11, 128), (16, 1 << 14),
                       (8192, 1), (64, 128))


def phase_kernel_vs_plain(device) -> float:
    """Every form and dtype of the route-stage kernel, on one vector and
    on a topic batch of TOPICS, bit for bit against its plain version on
    the card, and whole routes against the host's and the plain stages';
    returns max |err|."""
    import numpy as np
    import torch

    from protocol_tpu_torch.ops.clos import (
        apply_route,
        apply_route_np,
        plan_route,
        route_core,
    )
    from protocol_tpu_torch.ops.kernels import (
        FORWARD,
        MIDDLE,
        REVERSE,
        route_stage,
        route_stage_plain,
    )

    rng = np.random.default_rng(1)
    g = torch.Generator(device=device).manual_seed(2)
    worst = 0.0
    cases = []

    def held(x, idx, form, m):
        nonlocal worst
        y = route_stage(x, idx, form, m)
        torch.cuda.synchronize()
        ref = route_stage_plain(x, idx, form, m)
        err = float((y.double() - ref.double()).abs().max())
        exact = bool(torch.equal(y, ref))
        worst = max(worst, err)
        cases.append({"dtype": str(x.dtype).split(".")[1],
                      "form": _FORMS[form], "m": m, "T": x.shape[-2],
                      "K": x.shape[0] if x.dim() == 3 else None,
                      "bit_exact": exact, "max_abs_err": err})
        check(exact, f"route_stage differs from plain: {cases[-1]}")

    shapes = ([(MIDDLE, 1, T) for T in (1, 7, 8192, 262_144, 1000)]
              + [(form, m, m * B) for form in (FORWARD, REVERSE)
                 for m, B in ROUTE_STAGE_CASES])
    batched = ([(MIDDLE, 1, T) for T in (1000, 8192, 262_144)]
               + [(form, m, m * B) for form in (FORWARD, REVERSE)
                  for m, B in BATCHED_STAGE_CASES])
    for dtype in (torch.float32, torch.float64, torch.int32):
        for form, m, T in shapes:
            if dtype == torch.int32:
                x = torch.from_numpy(rng.integers(-2**31, 2**31 - 1,
                                                  (T, 128), dtype=np.int32))
            else:
                x = torch.from_numpy(rng.standard_normal((T, 128)))
            idx = torch.from_numpy(
                rng.integers(0, 128, (T, 128), dtype=np.uint8)).to(device)
            held(x.to(device=device, dtype=dtype), idx, form, m)
        # the topic batch, made on the card (a float64 batch at T =
        # 262,144 is 1.3 GB)
        for form, m, T in batched:
            if dtype == torch.int32:
                x = torch.randint(-2**31, 2**31 - 1, (TOPICS, T, 128),
                                  dtype=dtype, device=device, generator=g)
            else:
                x = torch.randn(TOPICS, T, 128, dtype=dtype, device=device,
                                generator=g)
            idx = torch.randint(0, 128, (T, 128), dtype=torch.uint8,
                                device=device, generator=g)
            held(x, idx, form, m)
            del x
    emit("kernel_vs_plain", cases=len(cases), all_bit_exact=True,
         max_abs_err=worst, shapes=[[_FORMS[f], m, T] for f, m, T in shapes],
         batched_shapes=[[TOPICS, _FORMS[f], m, T] for f, m, T in batched])

    e = 20
    perm = rng.permutation(1 << e)
    t0 = time.perf_counter()
    plan = plan_route(perm)
    plan_s = time.perf_counter() - t0
    x = rng.standard_normal(1 << e).astype(np.float32)
    stages = tuple(torch.from_numpy(s).to(device) for s in plan.stages)
    xd = torch.from_numpy(x).to(device)
    y = apply_route(xd, stages, plan.e, plan.bits).cpu().numpy()
    exact = bool(np.array_equal(y, apply_route_np(plan, x))
                 and np.array_equal(y, x[perm]))
    # the middle levels alone on 128 subproblems, from stage 1, as a
    # sharded route runs them on each device
    sub = route_core(xd, stages, 1, e - 7, plan.bits[1:])
    sub_plain = route_core(xd, stages, 1, e - 7, plan.bits[1:],
                           stage=route_stage_plain)
    sub_exact = bool(torch.equal(sub, sub_plain))
    emit("route_vs_numpy", e=e, bits=list(plan.bits), plan_s=plan_s,
         bit_exact=exact, batched_from_stage_1_bit_exact=sub_exact)
    check(exact, "routed permutation at e=20 differs from apply_route_np")
    check(sub_exact, "the batched middle levels differ from the plain stages")
    return worst


def _gather_forward(x, idx64, m: int):
    """One ``torch.gather`` call that computes a route stage's forward
    form, ``out[b, j, r] = x[b, r, idx[b, r, j]]``: the transpose is in
    the strides of its output (the library's time beside the kernel's;
    the port never calls it)."""
    import torch

    B = x.shape[0] // m
    buf = torch.empty_like(x)
    torch.gather(x.view(B, m, 128), 2, idx64.view(B, m, 128),
                 out=buf.view(B, 128, m).transpose(1, 2))
    return buf


def phase_kernel_times(device) -> dict:
    """The route-stage kernel at the main path's shapes (float32):
    T = 262,144 rows (edge route) and 8,192 (state route). Device ms per
    launch by CUDA-graph replay with the operands cycling through copies
    that outgrow the L2, for each form at each m the route gives it. At
    the route's first stage (forward, m = T), beside the kernel: its
    plain version; one ``torch.gather`` call that computes the same
    function (strided output); ``torch.gather`` and its transpose as the
    parent design ran them in torch (``.transpose(1, 2).contiguous()``);
    the parent design's kernel (the middle form, the lane permutation
    alone) followed by that transpose; the kernel with the same operands
    every launch (L2-warm) and back to back (host-paced)."""
    import torch

    from protocol_tpu_torch.ops.kernels import (
        FORWARD,
        MIDDLE,
        REVERSE,
        lane_perm,
        route_stage,
        route_stage_plain,
    )

    g = torch.Generator(device=device).manual_seed(2)
    rows = {}
    for T, launches, inner in ((262_144, 20, (1 << 11, 16)),
                               (8192, 200, (64,))):
        set_bytes = T * 128 * (4 + 1 + 8)  # x, idx and its int64 copy
        sets = min(launches, max(2, -(-COLD_BYTES // set_bytes)))
        xs = [torch.randn(T, 128, device=device, generator=g)
              for _ in range(sets)]
        idxs = [torch.randint(0, 128, (T, 128), device=device, generator=g,
                              dtype=torch.uint8) for _ in range(sets)]
        idx64s = [i.long() for i in idxs]

        def cold(fn):
            return graph_ms(lambda i: fn(xs[i % sets], idxs[i % sets],
                                         idx64s[i % sets]), launches)["ms"]

        def transposed(y):
            return y.view(1, T, 128).transpose(1, 2).contiguous()

        nbytes = T * 128 * (4 + 1 + 4)  # x read, idx read, out written
        forms = [{"form": _FORMS[f], "m": m, "ms": cold(
            lambda x, i, i64, f=f, m=m: route_stage(x, i, f, m))}
            for m in (T,) + inner for f in (FORWARD, REVERSE)]
        forms.append({"form": "middle", "m": None, "ms": cold(
            lambda x, i, i64: route_stage(x, i, MIDDLE))})
        rec = {
            "T": T, "m": T, "form": "forward", "operand_sets": sets,
            "graph_launches": launches,
            "ms": forms[0]["ms"],
            "plain_ms": cold(
                lambda x, i, i64: route_stage_plain(x, i, FORWARD, T)),
            "library_ms": cold(
                lambda x, i, i64: _gather_forward(x, i64, T)),
            "gather_ms": cold(lambda x, i, i64: torch.gather(x, 1, i64)),
            "gather_transpose_ms": cold(
                lambda x, i, i64: transposed(torch.gather(x, 1, i64))),
            "parent_design_ms": cold(
                lambda x, i, i64: transposed(lane_perm(x, i))),
            "same_inputs_ms": graph_ms(
                lambda i: route_stage(xs[0], idxs[0], FORWARD, T),
                launches)["ms"],
            "back_to_back_ms": cuda_ms(
                lambda: route_stage(xs[0], idxs[0], FORWARD, T), launches),
            "forms": forms,
            "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
        rec["achieved_GBps"] = nbytes / rec["ms"] / 1e6
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        emit("kernel_times", **rec, dtype="float32")
        rows[T] = rec
        del xs, idxs, idx64s
    return rows


def _parent_stage(x2d, idx2d, form: int, m: int):
    """A route stage as the parent design ran it: the lane-permutation
    kernel (the middle form) with the transpose as a torch copy."""
    from protocol_tpu_torch.ops.kernels import FORWARD, REVERSE, lane_perm

    T = x2d.shape[0]
    if form == REVERSE:
        x2d = x2d.view(T // m, 128, m).transpose(1, 2).contiguous()
    y = lane_perm(x2d.view(T, 128), idx2d)
    if form == FORWARD:
        y = y.view(T // m, m, 128).transpose(1, 2).contiguous()
    return y.view(T, 128)


def _sweep_breakdown(arrs, static, s, launches: int = 10) -> dict:
    """Device ms of one routed sweep and of each of its parts, by
    CUDA-graph replay: the sweep (``spmv_routed``) and the same sweep
    with each route run as the parent design ran it (``_parent_stage``);
    each route both ways, and the parent's transposes alone. The edge
    route's operands (128 MB and 7 × 32 MB of indices) outgrow the L2;
    the state route's cycle through copies of its input and its stages
    that do. Also checks, on random values, that both routes through the
    kernel equal the plain stages' routes and the parent's bit for bit,
    and that the sweep equals the parent's."""
    import torch

    from protocol_tpu_torch.ops.clos import route_core, route_forms
    from protocol_tpu_torch.ops.converge import dangling_and_damping
    from protocol_tpu_torch.ops.kernels import route_stage, route_stage_plain
    from protocol_tpu_torch.ops.routed import (
        blocked_broadcast,
        blocked_reduce,
        spmv_routed,
    )

    E, Z = 1 << static.edge_e, 1 << static.state_e

    def broadcast(s):
        return blocked_broadcast(arrs, s, static.out_widths, static.out_xs,
                                 E)

    def reduce(y):
        return blocked_reduce(arrs, y, static.in_widths, static.in_xs,
                              static.in_n_pos, Z)

    def edge_route(x, stage=route_stage):
        return route_core(x, arrs["edge_stages"], 0, static.edge_e,
                          static.edge_bits, stage)

    def state_route(z, stages=arrs["state_stages"], stage=route_stage):
        return route_core(z, stages, 0, static.state_e, static.state_bits,
                          stage)

    def parent_sweep(s):
        y = edge_route(broadcast(s), _parent_stage)
        return dangling_and_damping(
            arrs, s, state_route(reduce(y), stage=_parent_stage))

    g = torch.Generator(device=s.device).manual_seed(9)
    exact = {}
    for name, route, n in (("edge_route", edge_route, E),
                           ("state_route", state_route, Z)):
        r = torch.randn(n, device=s.device, generator=g)
        fused = route(r)
        exact[name] = bool(torch.equal(fused, route(r, stage=route_stage_plain))
                           and torch.equal(fused, route(r, stage=_parent_stage)))
    sweep_equal = bool(torch.equal(spmv_routed(arrs, static, s),
                                   parent_sweep(s)))

    x = broadcast(s)
    y = edge_route(x)
    z = reduce(y)
    sets = min(40, max(2, -(-COLD_BYTES // (
        Z * 4 + len(arrs["state_stages"]) * Z))))
    zs = [z.clone() for _ in range(sets)]
    stage_sets = [tuple(t.clone() for t in arrs["state_stages"])
                  for _ in range(sets)]

    def ms(fn, n=launches):
        return graph_ms(fn, n)["ms"]

    def transposes(i):  # the parent's six edge-route transposes alone
        for _, form, m in route_forms(static.edge_e, static.edge_bits):
            if form == 0:
                x.view(-1, m, 128).transpose(1, 2).contiguous()
            elif form == 2:
                x.view(-1, 128, m).transpose(1, 2).contiguous()

    out = {
        "sweep": ms(lambda i: spmv_routed(arrs, static, s)),
        "sweep_parent_design": ms(lambda i: parent_sweep(s)),
        "broadcast": ms(lambda i: broadcast(s)),
        "edge_route": ms(lambda i: edge_route(x)),
        "edge_route_parent_design": ms(
            lambda i: edge_route(x, _parent_stage)),
        "edge_route_transposes_parent_design": ms(transposes),
        "reduce": ms(lambda i: reduce(y)),
        "state_route": ms(lambda i: state_route(zs[i], stage_sets[i]),
                          sets),
        "state_route_parent_design": ms(
            lambda i: state_route(zs[i], stage_sets[i], _parent_stage),
            sets),
        "dangling_damping": ms(lambda i: dangling_and_damping(arrs, s, z)),
        "state_route_operand_sets": sets,
        "routes_bit_exact_vs_plain_and_parent": exact,
        "sweep_equal_to_parent_design": sweep_equal,
    }
    del zs, stage_sets
    torch.cuda.synchronize()
    return out


def phase_main_path(device) -> tuple:
    """The 1M-peer routed converge through TorchRoutedBackend; returns the
    lane_perm launches it made and the graph with its routed operator
    (``n, src, dst, val, valid, op``), which the churn and topic phases
    reuse rather than build a second plan."""
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
    routes_exact = breakdown["routes_bit_exact_vs_plain_and_parent"]
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
    gather_sweep_graph_ms = graph_ms(lambda i: spmv(garrs, gs), 10)["ms"]
    del garrs

    emit("main_path", engine="routed", dtype="float32", alpha=ALPHA,
         tol=TOL, iterations=iters, delta=delta, converge_s=converge_s,
         sweep_ms=sweep_ms, sweep_breakdown_ms=breakdown,
         gather_f32_sweep_ms=gather_sweep_ms,
         gather_f32_sweep_graph_ms=gather_sweep_graph_ms,
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
    check(all(routes_exact.values()), "a route through the kernel differs "
          f"from the plain stages' or the parent's: {routes_exact}")
    check(launches == iters * stages_per_sweep,
          f"lane_perm launched {launches} times, expected "
          f"{iters} sweeps × {stages_per_sweep}")
    return launches, (n, src, dst, val, valid, op)


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


def _timed_apply(eng, deltas) -> float:
    """ms of one ``apply_deltas``, its device writes included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ok = eng.apply_deltas(deltas)
    torch.cuda.synchronize()
    check(ok, f"delta batch rejected: {eng.stats}")
    return (time.perf_counter() - t0) * 1e3


def _new_edges(rng, eng, count: int):
    """``count`` (src, dst) pairs the anchored graph does not have."""
    import numpy as np

    n = eng.n_now
    cand = rng.integers(0, n, (4 * count, 2))
    cand = cand[cand[:, 0] != cand[:, 1]]
    key = (cand[:, 0].astype(np.int64) << 32) | cand[:, 1]
    key, first = np.unique(key, return_index=True)
    cand = cand[first[~np.isin(key, eng.key)]]
    check(len(cand) >= count, "not enough new edges drawn")
    return cand[rng.permutation(len(cand))[:count]]


def _rel_l1(a, b) -> float:
    import numpy as np

    return float(np.sum(np.abs(a - b)) / np.sum(np.abs(b)))


def _churn_errors(s, s_ref, rows) -> dict:
    """Scores against a rebuild's: relative L1 over all peers, and the
    largest relative difference of one peer among ``rows``."""
    import numpy as np

    return {"rel_l1": _rel_l1(s, s_ref),
            "max_rel_touched": float(np.max(np.abs(s[rows] - s_ref[rows])
                                            / np.abs(s_ref[rows])))}


def _churn_ok(err: dict) -> bool:
    return (err["rel_l1"] <= DELTA_REL_L1
            and err["max_rel_touched"] <= DELTA_MAX_REL_TOUCHED)


def phase_delta(device, graph) -> dict:
    """The churn path at 1M peers on the main path's operator (no second
    plan build): a ``DeltaEngine`` anchored on it converges cold, absorbs
    DELTA_BATCHES ``revision_batch``es of DELTA_BATCH_EDGES revisions
    and one batch of DELTA_INSERTS new edges (the COO tail), and
    converges warm on the patched operator (the ladder's full rung, B1
    on every route stage). Checks: no full build in the window, B1's
    launches = sweeps × 12, and the warm scores against a from-scratch
    float64 gather converge of the churned edges: within DELTA_PARITY
    of the largest score (the serve smoke's bound), within DELTA_REL_L1
    relative L1, and within DELTA_MAX_REL_TOUCHED of each renormalized
    row's and tail destination's own score. The engine's state with its
    tail fold dropped, and with its row rescale reset to 1, must each
    fail those bounds (the bounds catch such a fault). Then the ladder: a localized
    window (LADDER_LOCAL revisions, ``device_threshold=0``) must be
    served by ``device_partial``, a flooded one (LADDER_FLOOD, past a
    frontier limit of a quarter of its frontier) by ``sampled``, each
    within ``(budget_spent + 2e-6) / alpha`` relative L1 of the full
    converge from the same published vector."""
    import numpy as np
    import torch

    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.graph import filter_edges
    from protocol_tpu_torch.incremental import (
        DeltaEngine,
        ladder_refresh,
        revision_batch,
    )
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.routed import (
        converge_routed_adaptive,
        spmv_routed,
    )
    from protocol_tpu_torch.utils import trace

    n, src, dst, val, valid, op = graph
    rng = np.random.default_rng(DELTA_SEED)
    fsrc, fdst, _, _, _, raw, _ = filter_edges(n, src, dst, val, valid,
                                               return_raw=True)
    cur = raw.copy()
    stages = len(op.edge_stages) + len(op.state_stages)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng = DeltaEngine.anchor(n, src, dst, val, valid, op, alpha=ALPHA,
                             device=device)
    anchor_s = time.perf_counter() - t0
    s_pub, it_cold, d_cold = eng.converge(eng.initial_node_scores(1000.0),
                                          MAX_ITERATIONS, TOL)
    eng.take_frontier()
    builds0 = trace.counter_total("operator_full_builds")
    apply_ms = [_timed_apply(eng, revision_batch(rng, fsrc, fdst, cur,
                                                 DELTA_BATCH_EDGES))
                for _ in range(DELTA_BATCHES)]
    # host ms per batch by kind (the engine's spans; device writes are
    # enqueued inside them, the synchronised total is apply_ms)
    apply_kind_ms = {
        dict(labels)["kind"]: v["sum"] * 1e3 / DELTA_BATCHES
        for labels, v in trace.histogram("operator_delta_seconds").series()}
    new = _new_edges(rng, eng, DELTA_INSERTS)
    new_val = rng.integers(1, 11, len(new)).astype(np.float64)
    insert_ms = _timed_apply(eng, [(int(a), int(b), None, float(w))
                                   for (a, b), w in zip(new, new_val)])
    builds1 = trace.counter_total("operator_full_builds")
    t0 = time.perf_counter()
    s_warm, it_warm, d_warm = eng.converge(s_pub, MAX_ITERATIONS, TOL)
    warm_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["lane_perm"]

    s0 = torch.from_numpy(eng.scores_to_state(s_warm)).to(device)
    sweep_ms = cuda_ms(lambda: spmv_routed(eng.arrs, eng.static, s0), 10)
    s_ref, it_ref, _ = TorchSparseBackend(
        dtype=torch.float64, device=device).converge_edges(
        n, np.concatenate([fsrc, new[:, 0]]),
        np.concatenate([fdst, new[:, 1]]), np.concatenate([cur, new_val]),
        valid, 1000.0, MAX_ITERATIONS, tol=TOL, alpha=ALPHA)
    parity = float(np.max(np.abs(s_warm - s_ref)) / np.max(np.abs(s_ref)))
    touched = np.union1d(np.fromiter(eng.dirty_rows, np.int64), new[:, 1])
    touched = touched[s_ref[touched] > 0]
    errors = _churn_errors(s_warm, s_ref, touched)
    # the same warm converge on the engine's state with one repair
    # undone: the bounds must reject both
    faults = {}
    s0_pub = torch.from_numpy(eng.scores_to_state(s_pub)).to(device)
    for name, undo in (
            ("tail_fold_dropped", {k: eng.arrs[k][:0] for k in
                                   ("tail_src", "tail_dst", "tail_w")}),
            ("row_rescale_dropped", {"inv_row_scale": torch.ones_like(
                eng.arrs["inv_row_scale"])})):
        s_bad, _, _ = converge_routed_adaptive(
            {**eng.arrs, **undo}, eng.static, s0_pub, tol=TOL,
            max_iterations=MAX_ITERATIONS)
        faults[name] = _churn_errors(
            eng.scores_to_nodes(s_bad.cpu().numpy()).astype(np.float64),
            s_ref, touched)
        faults[name]["rejected"] = not _churn_ok(faults[name])
    eng.take_frontier()

    ladder = {}
    s_pub = s_warm
    for name, count, want in (("local", LADDER_LOCAL, "device_partial"),
                              ("flood", LADDER_FLOOD, "sampled")):
        window_ms = _timed_apply(eng, revision_batch(rng, fsrc, fdst, cur,
                                                     count))
        frontier, ok = eng.take_frontier()
        limit = n if name == "local" else max(len(frontier) // 4, 1)
        def refresh():
            return ladder_refresh(eng, s_pub, frontier, TOL,
                                  MAX_ITERATIONS, limit,
                                  device_threshold=0, sample_budget=n,
                                  error_budget=LADDER_ERROR_BUDGET)

        t0 = time.perf_counter()
        res, mode = refresh()
        torch.cuda.synchronize()
        ladder_s = time.perf_counter() - t0
        # the same refresh again (it leaves the engine as it was) under
        # the profiler: how much of its wall the card is busy
        (res2, _), busy_ms, events = device_busy(refresh)
        check((res is None) == (res2 is None) and (
            res is None or np.array_equal(res2.scores, res.scores)),
            f"ladder {name}: a second run of the refresh differs")
        t0 = time.perf_counter()
        s_full, it_full, _ = eng.converge(s_pub, MAX_ITERATIONS, TOL)
        full_s = time.perf_counter() - t0
        rec = {"revisions": count, "apply_ms": window_ms,
               "frontier": len(frontier), "partial_ok": ok,
               "frontier_limit": limit, "mode": mode, "want": want,
               "ladder_s": ladder_s, "device_busy_ms": busy_ms,
               "device_events": events, "full_s": full_s,
               "full_iterations": it_full}
        if res is not None:
            bound = (res.budget_spent + 2e-6) / ALPHA
            rec.update(sweeps=res.sweeps, residual=res.residual,
                       frontier_peak=res.frontier_peak,
                       resamples=res.resamples,
                       budget_spent=res.budget_spent,
                       rel_l1_vs_full=_rel_l1(res.scores, s_full),
                       bound=bound)
        ladder[name] = rec
        s_pub = s_full

    rec = {
        "peers": n, "filtered_edges": len(fsrc), "alpha": ALPHA,
        "anchor_s": anchor_s,
        "cold_iterations": it_cold, "cold_delta": d_cold,
        "batches": DELTA_BATCHES, "batch_edges": DELTA_BATCH_EDGES,
        "apply_ms_median": float(np.median(apply_ms)),
        "apply_ms": apply_ms, "apply_host_ms_by_kind": apply_kind_ms,
        "insert_edges": DELTA_INSERTS,
        "insert_ms": insert_ms, "tail": len(eng.tail_index),
        "stats": dataclasses.asdict(eng.stats),
        "full_builds_before": builds0, "full_builds_after": builds1,
        "warm_iterations": it_warm, "warm_delta": d_warm,
        "warm_converge_s": warm_s, "patched_sweep_ms": sweep_ms,
        "lane_perm_launches": launches,
        "expected_launches": (it_cold + it_warm) * stages,
        "gather_f64_iterations": it_ref,
        "max_rel_diff_vs_gather_f64": parity,
        "touched_peers": len(touched), "vs_gather_f64": errors,
        "bounds": {"rel_l1": DELTA_REL_L1,
                   "max_rel_touched": DELTA_MAX_REL_TOUCHED},
        "faults_vs_gather_f64": faults, "ladder": ladder,
    }
    emit("delta", **rec)
    check(builds1 == builds0 >= 1, f"the churn window paid full builds "
          f"({builds0} -> {builds1})")
    check(d_warm <= TOL and np.isfinite(s_warm).all(),
          f"warm converge stopped at delta {d_warm}")
    check(launches == (it_cold + it_warm) * stages,
          f"lane_perm launched {launches} times on the churn path, "
          f"expected {it_cold + it_warm} sweeps × {stages}")
    check(parity <= DELTA_PARITY, f"delta-maintained scores differ from "
          f"the float64 rebuild by {parity} (bound {DELTA_PARITY})")
    check(_churn_ok(errors), f"delta-maintained scores differ from the "
          f"float64 rebuild: {errors} (bounds {rec['bounds']})")
    check(all(f["rejected"] for f in faults.values()),
          f"the churn bounds pass an engine fault: {faults}")
    for name, r in ladder.items():
        check(r["mode"] == r["want"], f"ladder {name}: served by "
              f"{r['mode']}, expected {r['want']}")
        check(r["rel_l1_vs_full"] <= r["bound"], f"ladder {name}: rel L1 "
              f"{r['rel_l1_vs_full']} past {r['bound']}")
    return rec


def phase_topics(device, graph) -> dict:
    """TOPICS topic vectors through the main path's routed operator in one
    batched loop (``TorchRoutedBackend.converge_topics``): every route
    stage one launch for the whole batch. Checks: the batched edge and
    state routes bit-exact against K single routes and against the plain
    stages on the same input; each topic within rtol 1e-4 of its own
    routed converge, iterations ±1; launches = batched sweeps × 12.
    Times the batched sweep against K single sweeps, and the batched
    stage (forward, m = T) at both route sizes beside its bound, by
    graph replay, after holding it against its plain version once."""
    import numpy as np
    import torch

    from protocol_tpu_torch.backend import TorchRoutedBackend
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.clos import route_core
    from protocol_tpu_torch.ops.kernels import (
        FORWARD,
        route_stage,
        route_stage_plain,
    )
    from protocol_tpu_torch.ops.routed import routed_arrays, spmv_routed

    n, src, dst, val, valid, op = graph
    k = TOPICS
    rng = np.random.default_rng(11)
    s0k = rng.uniform(0.5, 1.5, (k, n)) * 1000.0
    backend = TorchRoutedBackend(dtype=torch.float32, device=device)
    stages = len(op.edge_stages) + len(op.state_stages)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    scores, iters, delta = backend.converge_topics(
        n, src, dst, val, valid, s0k, MAX_ITERATIONS, tol=TOL, alpha=ALPHA,
        operator=op)
    batch_s = time.perf_counter() - t0
    launches = kernels.LAUNCHES["lane_perm"]
    singles = []
    t0 = time.perf_counter()
    for t in range(k):
        singles.append(backend.converge_edges(
            n, src, dst, val, valid, 1000.0, MAX_ITERATIONS, tol=TOL,
            alpha=ALPHA, operator=op, s0=s0k[t]))
    singles_s = time.perf_counter() - t0
    close = [bool(np.allclose(scores[t], s, rtol=1e-4, atol=0.0))
             for t, (s, _, _) in enumerate(singles)]
    worst = max(float(np.max(np.abs(scores[t] - s) / np.abs(s)))
                for t, (s, _, _) in enumerate(singles))

    arrs, static = routed_arrays(op, dtype=torch.float32, alpha=ALPHA,
                                 device=device)
    g = torch.Generator(device=device).manual_seed(5)
    exact, exact_plain = {}, {}
    for name, key, e, bits in (
            ("edge_route", "edge_stages", static.edge_e, static.edge_bits),
            ("state_route", "state_stages", static.state_e,
             static.state_bits)):
        x = torch.randn(k, 1 << e, device=device, generator=g)
        y = route_core(x, arrs[key], 0, e, bits)
        exact[name] = all(torch.equal(y[t], route_core(x[t], arrs[key], 0,
                                                       e, bits))
                          for t in range(k))
        exact_plain[name] = bool(torch.equal(y, route_core(
            x, arrs[key], 0, e, bits, stage=route_stage_plain)))
        del x, y
    sk = torch.from_numpy(np.stack([op.scores_from_nodes(r)
                                    for r in s0k])).to(device)
    sweep_batch_ms = graph_ms(lambda i: spmv_routed(arrs, static, sk),
                              5)["ms"]
    sweep_singles_ms = graph_ms(
        lambda i: [spmv_routed(arrs, static, sk[t]) for t in range(k)],
        5)["ms"]
    del arrs

    stage_rows = {}
    for T, launch_n in ((262_144, 10), (8192, 100)):
        set_bytes = T * 128 * (4 * k + 1)
        sets = min(launch_n, max(2, -(-COLD_BYTES // set_bytes)))
        xs = [torch.randn(k, T, 128, device=device, generator=g)
              for _ in range(sets)]
        idxs = [torch.randint(0, 128, (T, 128), device=device, generator=g,
                              dtype=torch.uint8) for _ in range(sets)]
        stage_exact = bool(torch.equal(
            route_stage(xs[0], idxs[0], FORWARD, T),
            route_stage_plain(xs[0], idxs[0], FORWARD, T)))
        ms = graph_ms(lambda i: route_stage(xs[i % sets], idxs[i % sets],
                                            FORWARD, T), launch_n)["ms"]
        single_ms = graph_ms(lambda i: route_stage(
            xs[i % sets][0], idxs[i % sets], FORWARD, T), launch_n)["ms"]
        nbytes = T * 128 * (8 * k + 1)
        stage_rows[T] = {"T": T, "K": k, "form": "forward", "m": T,
                         "bit_exact_vs_plain": stage_exact,
                         "ms": ms, "one_vector_ms": single_ms,
                         "bytes": nbytes,
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        stage_rows[T]["share_of_bound"] = \
            stage_rows[T]["bound_ms"] / ms
        del xs, idxs

    rec = {"topics": k, "peers": n, "iterations": iters.tolist(),
           "delta": delta.tolist(), "batch_converge_s": batch_s,
           "single_iterations": [int(i) for _, i, _ in singles],
           "singles_converge_s": singles_s,
           "max_rel_diff_vs_single": worst, "close_rtol_1e-4": close,
           "routes_bit_exact_vs_single": exact,
           "routes_bit_exact_vs_plain_stages": exact_plain,
           "lane_perm_launches": launches,
           "expected_launches": int(max(iters)) * stages,
           "sweep_batch_ms": sweep_batch_ms,
           "sweep_k_singles_ms": sweep_singles_ms,
           "batched_stage": list(stage_rows.values())}
    emit("topics", **rec)
    check(all(exact.values()), f"batched routes differ from single: {exact}")
    check(all(exact_plain.values()), f"batched routes differ from the plain "
          f"stages': {exact_plain}")
    check(all(r["bit_exact_vs_plain"] for r in stage_rows.values()),
          "the timed batched stage differs from its plain version")
    check(all(close), f"topic scores differ from their own converges "
          f"(max rel {worst})")
    check(all(abs(int(i) - s[1]) <= 1 for i, s in zip(iters, singles)),
          f"topic iterations {iters.tolist()} vs single "
          f"{[s[1] for s in singles]}")
    check(launches == int(max(iters)) * stages,
          f"lane_perm launched {launches} times for the topic batch, "
          f"expected {int(max(iters))} sweeps × {stages}")
    return rec


# --- phase sharded: the device mesh (parallel/) -------------------------------

_COUNTED = ("lane_perm", "mont_mul", "add_mod", "sub_mod")


def _launch_counts() -> dict:
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.kernels import field_kernel as fk

    return {"lane_perm": kernels.LAUNCHES["lane_perm"],
            **{k: fk.LAUNCHES[k] for k in _COUNTED[1:]}}


class _Tally:
    """The kernels' launches inside ``count()`` blocks only (the sharded
    calls, not the single-device runs they are compared with), summed
    over the phase; each block's own counts land in the dict it yields."""

    def __init__(self):
        self.total = dict.fromkeys(_COUNTED, 0)

    @contextlib.contextmanager
    def count(self):
        before = _launch_counts()
        got: dict = {}
        yield got
        after = _launch_counts()
        for k in _COUNTED:
            got[k] = after[k] - before[k]
            self.total[k] += got[k]


def _rel_conservation(scores, n_valid: int) -> float:
    import numpy as np

    total = n_valid * 1000.0
    return abs(float(np.sum(scores, dtype=np.float64)) - total) / total


def _route_exchange(xs: list, e: int, mesh) -> list:
    """The exchanges of one sharded route (``sharded_apply_route``)
    without its B1 stages: the level-0 shuffle with its local transpose,
    then the inverse."""
    from protocol_tpu_torch.parallel.mesh import all_to_all

    d = mesh.size
    m = 1 << (e - 7)
    ys = all_to_all([x.view(-1, 128) for x in xs], mesh, split_dim=1,
                    concat_dim=0)
    ys = [y.t().reshape(-1) for y in ys]
    ys = [y.view(128 // d, m).t() for y in ys]
    return all_to_all(ys, mesh, split_dim=0, concat_dim=1)


def _sharded_converges(device, graph, mesh, tally) -> dict:
    """The converge graph sharded by rows (gather) and by the Clos route
    (device-major plan) over ``mesh``: SHARDED_FIXED_SWEEPS fixed sweeps
    and an adaptive run at α = ALPHA in float32, each held against the
    single-device gather or routed converge of the same graph within the
    reference's float32 bound (rtol 1e-4, atol 0.5; iterations ±1), mass
    conserved, B1 launched ``lane_perm_launches_per_sweep`` times a
    routed sweep. Timed: each sharded build, and the sweeps by graph
    replay beside the single-device ones and the exchanges alone."""
    import numpy as np
    import torch

    from protocol_tpu_torch.graph import build_operator
    from protocol_tpu_torch.ops.converge import (
        converge_sparse_adaptive,
        converge_sparse_fixed,
        operator_arrays,
        spmv,
    )
    from protocol_tpu_torch.ops.routed import (
        converge_routed_adaptive,
        converge_routed_fixed,
        routed_arrays,
        spmv_routed,
    )
    from protocol_tpu_torch.parallel import (
        build_sharded_operator,
        build_sharded_routed_operator,
        place_sharded,
        place_sharded_routed,
        sharded_converge_adaptive,
        sharded_converge_fixed,
        sharded_routed_converge_adaptive,
        sharded_routed_converge_fixed,
    )
    from protocol_tpu_torch.parallel.converge import _sweep
    from protocol_tpu_torch.parallel.mesh import all_gather, shard
    from protocol_tpu_torch.parallel.routed import (
        lane_perm_launches_per_sweep,
        sharded_routed_spmv,
    )

    n, src, dst, val, valid, op = graph
    f32 = torch.float32
    sweeps = SHARDED_FIXED_SWEEPS

    def close(a, b):
        return (bool(np.allclose(a, b, rtol=1e-4, atol=0.5)),
                float(np.max(np.abs(np.asarray(a, np.float64) - b))))

    # --- the single-device runs they are held against
    gop = build_operator(n, src, dst, val, valid)
    garrs = operator_arrays(gop, dtype=f32, alpha=ALPHA, device=device)
    gs0 = torch.from_numpy(gop.valid * 1000.0).to(device, f32)
    g_fixed = converge_sparse_fixed(garrs, gs0, sweeps).cpu().numpy()
    g_ad, g_iters, _ = converge_sparse_adaptive(garrs, gs0, TOL,
                                                MAX_ITERATIONS)
    g_ad = g_ad.cpu().numpy()
    gather_sweep_ms = graph_ms(lambda i: spmv(garrs, gs0), 10)["ms"]
    del garrs
    rarrs, rstatic = routed_arrays(op, dtype=f32, alpha=ALPHA, device=device)
    rs0 = torch.from_numpy(op.initial_scores(1000.0)).to(device)
    r_fixed = op.scores_for_nodes(
        converge_routed_fixed(rarrs, rstatic, rs0, sweeps).cpu().numpy())
    r_ad, r_iters, _ = converge_routed_adaptive(rarrs, rstatic, rs0, TOL,
                                                MAX_ITERATIONS)
    r_ad = op.scores_for_nodes(r_ad.cpu().numpy())
    routed_sweep_ms = graph_ms(lambda i: spmv_routed(rarrs, rstatic, rs0),
                               10)["ms"]
    del rarrs
    torch.cuda.empty_cache()

    # --- row-sharded gather
    t0 = time.perf_counter()
    sop = build_sharded_operator(n, src, dst, val, valid,
                                 num_shards=mesh.size)
    gather_build_s = time.perf_counter() - t0
    placed = place_sharded(sop, mesh, f32, ALPHA)
    s0 = sop.initial_scores(1000.0, dtype=f32)
    with tally.count():
        t0 = time.perf_counter()
        fixed = sharded_converge_fixed((sop, placed), s0, sweeps, mesh,
                                       alpha=ALPHA).cpu().numpy()[:n]
        gather_fixed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ad, ad_iters, ad_delta = sharded_converge_adaptive(
            (sop, placed), s0, mesh, tol=TOL, max_iterations=MAX_ITERATIONS,
            alpha=ALPHA)
        gather_adaptive_s = time.perf_counter() - t0
    ad = ad.cpu().numpy()[:n]
    blocks = shard(s0.to(device), mesh)
    nv = float(sop.n_valid)
    gather = {
        "build_s": gather_build_s, "fixed_s": gather_fixed_s,
        "adaptive_s": gather_adaptive_s, "iterations": ad_iters,
        "delta": ad_delta, "single_iterations": g_iters,
        "sweep_ms": graph_ms(lambda i: _sweep(placed, blocks, nv, mesh),
                             10)["ms"],
        "sweep_host_paced_ms": cuda_ms(lambda: _sweep(placed, blocks, nv,
                                                      mesh), 10),
        "exchange_ms": graph_ms(lambda i: all_gather(blocks, mesh),
                                10)["ms"],
        "single_sweep_ms": gather_sweep_ms,
        "fixed_close": close(fixed, g_fixed[:n]),
        "adaptive_close": close(ad, g_ad[:n]),
        "conservation_rel_err": _rel_conservation(ad, sop.n_valid)}
    gather["exchange_share"] = gather["exchange_ms"] / gather["sweep_ms"]
    del placed, blocks
    torch.cuda.empty_cache()

    # --- Clos-routed, device-major
    t0 = time.perf_counter()
    rop = build_sharded_routed_operator(n, src, dst, val, valid,
                                        num_shards=mesh.size)
    routed_build_s = time.perf_counter() - t0
    per_sweep = lane_perm_launches_per_sweep(rop)
    placed = place_sharded_routed(rop, mesh, f32, ALPHA)
    s0 = torch.from_numpy(rop.initial_scores(1000.0))
    with tally.count() as fixed_launches:
        t0 = time.perf_counter()
        fixed = rop.scores_for_nodes(sharded_routed_converge_fixed(
            (rop, placed), s0, sweeps, mesh))
        routed_fixed_s = time.perf_counter() - t0
    with tally.count() as ad_launches:
        t0 = time.perf_counter()
        ad, ad_iters, ad_delta = sharded_routed_converge_adaptive(
            (rop, placed), s0, mesh, tol=TOL, max_iterations=MAX_ITERATIONS)
        routed_adaptive_s = time.perf_counter() - t0
    ad = rop.scores_for_nodes(ad)
    blocks = shard(s0.to(device), mesh)
    e_loc = (1 << rop.edge_e) // mesh.size
    z_loc = (1 << rop.state_e) // mesh.size
    xe = [torch.randn(e_loc, device=device) for _ in range(mesh.size)]
    xz = [torch.randn(z_loc, device=device) for _ in range(mesh.size)]
    routed = {
        "build_s": routed_build_s, "fixed_s": routed_fixed_s,
        "adaptive_s": routed_adaptive_s, "iterations": ad_iters,
        "delta": ad_delta, "single_iterations": r_iters,
        "edge_e": rop.edge_e, "edge_bits": list(rop.edge_bits),
        "state_e": rop.state_e, "state_bits": list(rop.state_bits),
        "lane_perm_per_sweep": per_sweep,
        "lane_perm_launches": {"fixed": fixed_launches["lane_perm"],
                               "adaptive": ad_launches["lane_perm"]},
        "sweep_ms": graph_ms(lambda i: sharded_routed_spmv(
            placed, blocks, rop, mesh), 5)["ms"],
        "sweep_host_paced_ms": cuda_ms(lambda: sharded_routed_spmv(
            placed, blocks, rop, mesh), 5),
        "exchange_ms": graph_ms(lambda i: (
            _route_exchange(xe, rop.edge_e, mesh),
            _route_exchange(xz, rop.state_e, mesh)), 5)["ms"],
        "single_sweep_ms": routed_sweep_ms,
        "fixed_close": close(fixed, r_fixed),
        "adaptive_close": close(ad, r_ad),
        "conservation_rel_err": _rel_conservation(ad, rop.n_valid)}
    routed["exchange_share"] = routed["exchange_ms"] / routed["sweep_ms"]
    del placed, blocks, xe, xz
    torch.cuda.empty_cache()

    rec = {"shards": mesh.size, "peers": n, "sweeps": sweeps,
           "gather": gather, "routed": routed}
    emit("sharded_converge", **rec)
    for name, r in (("gather", gather), ("routed", routed)):
        check(r["fixed_close"][0], f"sharded {name}: {sweeps} sweeps differ "
              f"from the single-device run (max |diff| "
              f"{r['fixed_close'][1]})")
        check(r["adaptive_close"][0], f"sharded {name}: the adaptive run "
              f"differs (max |diff| {r['adaptive_close'][1]})")
        check(abs(r["iterations"] - r["single_iterations"]) <= 1,
              f"sharded {name}: {r['iterations']} iterations against "
              f"{r['single_iterations']}")
        check(r["delta"] <= TOL, f"sharded {name} stopped at {r['delta']}")
        check(r["conservation_rel_err"] < 1e-4,
              f"sharded {name}: mass not conserved")
    check(fixed_launches["lane_perm"] == sweeps * per_sweep,
          f"sharded routed: B1 launched {fixed_launches['lane_perm']} times "
          f"in {sweeps} sweeps, not {sweeps} × {per_sweep}")
    check(ad_launches["lane_perm"] == ad_iters * per_sweep,
          f"sharded routed: B1 launched {ad_launches['lane_perm']} times "
          f"in {ad_iters} sweeps, not {ad_iters} × {per_sweep}")
    return rec


def _sharded_checkpoint_cli(tally) -> dict:
    """``sparse-scores --checkpoint-dir`` on a CLI_PEERS-peer edge list
    through the port's CLI (its mesh: every GPU), the operator cached
    after the first build: one uninterrupted run, and a run stopped
    after one chunk (``--max-iterations`` = one chunk, exit 1, not
    converged) and resumed from its checkpoint; the resumed scores
    within the reference's resume bound (rtol 1e-5, atol 1e-2) of the
    uninterrupted ones, at the same iteration count."""
    import numpy as np

    from protocol_tpu_torch.graph import barabasi_albert_edges

    n = CLI_PEERS
    src, dst, val = barabasi_albert_edges(n, BA_M, seed=1)
    every = SHARDED_CHECKPOINT_EVERY
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        np.savetxt(Path(d) / "edges.csv",
                   np.stack([src, dst, val.astype(np.int64)], axis=1),
                   fmt="%d", delimiter=",")
        base = ["--assets", d, "sparse-scores", "--edges", "edges.csv",
                "--n", n, "--alpha", ALPHA, "--operator-cache", "opcache",
                "--checkpoint-every", every]
        runs = {}
        for name, extra in (
                ("uninterrupted", ["--checkpoint-dir", "ck_full", "--out",
                                   "full.csv"]),
                ("stopped", ["--checkpoint-dir", "ck", "--max-iterations",
                             every, "--out", "stopped.csv"]),
                ("resumed", ["--checkpoint-dir", "ck", "--out",
                             "resumed.csv"])):
            with tally.count() as launches:
                t0 = time.perf_counter()
                rc, out, err = _cli(base + extra)
                wall = time.perf_counter() - t0
            runs[name] = {"rc": rc, "wall_s": wall,
                          "stdout": out.strip()[-200:],
                          "stderr": err.strip()[-400:],
                          "launches": launches}
            check(rc == (1 if name == "stopped" else 0),
                  f"sparse-scores --checkpoint-dir ({name}): {runs[name]}")
        steps = sorted(p.name for p in (Path(d) / "ck").glob("step-*.npz"))
        full = np.loadtxt(Path(d) / "full.csv", delimiter=",", skiprows=1)
        resumed = np.loadtxt(Path(d) / "resumed.csv", delimiter=",",
                             skiprows=1)
    iters = {k: re.search(r"after (\d+) iterations", r["stdout"])
             for k, r in runs.items()}
    rec = {"peers": n, "edges": len(src), "checkpoint_every": every,
           "runs": runs, "step_files": steps,
           "max_abs_diff": float(np.max(np.abs(full[:, 1] - resumed[:, 1]))),
           "close": bool(np.allclose(resumed[:, 1], full[:, 1], rtol=1e-5,
                                     atol=1e-2))}
    emit("sharded_checkpoint", **rec)
    check("NOT converged" in runs["stopped"]["stdout"],
          f"the run stopped after one chunk did not stop: {runs['stopped']}")
    check(len(steps) >= 2, f"no checkpoints written: {steps}")
    check(all(iters.values()) and iters["resumed"].group(1)
          == iters["uninterrupted"].group(1),
          "the resumed run's iterations differ from the uninterrupted run's")
    check(rec["close"], f"resumed scores differ (max |diff| "
          f"{rec['max_abs_diff']})")
    check(all(r["launches"]["lane_perm"] > 0 for r in runs.values()),
          "a checkpointed CLI run did not launch B1")
    return rec


def _sharded_ingest(device, mesh, tally) -> dict:
    """``sharded_recover_batch`` over INGEST_ATTESTATIONS lanes of the
    ingest phase's fixture (forged lanes included) against one
    single-device ``recover_batch`` call on the same lanes: keys and
    mask equal, every honest lane its signer's key."""
    import numpy as np
    import torch

    from protocol_tpu_torch.ops import secp_batch as sb
    from protocol_tpu_torch.parallel.ingest import sharded_recover_batch

    atts, signer, forged, _ = _ingest_fixture(random.Random(6))
    hashes = [int(a.attestation.to_scalar().hash())
              for a in atts[:INGEST_DISTINCT]]
    msgs = [hashes[i % INGEST_DISTINCT] for i in range(len(atts))]
    sigs = [a.signature.to_signature() for a in atts]
    rs, ss, recs = ([s.r for s in sigs], [s.s for s in sigs],
                    [s.rec_id for s in sigs])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sb.recover_batch(rs, ss, recs, msgs, device=device)
    single_s = time.perf_counter() - t0
    with tally.count() as launches:
        t0 = time.perf_counter()
        got = sharded_recover_batch(rs, ss, recs, msgs, mesh)
        sharded_s = time.perf_counter() - t0
    honest = [i for i, k in enumerate(signer) if k >= 0]
    keys_ok = all(got[2][i] for i in honest)
    rec = {"lanes": len(atts), "shards": mesh.size,
           "single_s": single_s, "sharded_s": sharded_s,
           "keys_equal": got[0] == want[0] and got[1] == want[1],
           "mask_equal": bool(np.array_equal(got[2], want[2])),
           "honest_valid": keys_ok, "valid": int(np.sum(got[2])),
           "forged": {k: len(v) for k, v in forged.items()},
           "launches": launches}
    emit("sharded_ingest", **rec)
    check(rec["keys_equal"] and rec["mask_equal"],
          "the sharded recovery differs from the single-device one")
    check(keys_ok, "an honest lane came back invalid")
    for kind in ("r_at_least_n", "r_does_not_lift"):
        check(not any(got[2][i] for i in forged[kind]),
              f"a forged lane ({kind}) came back valid")
    return rec


def _sharded_ntt(device, mesh, tally) -> dict:
    """``ntt_sharded`` at 2^SHARDED_NTT_K equal to ``ntt`` bit for bit;
    both timed by graph replay, and the sharded transform's
    ``psum_scatter`` alone."""
    import torch

    from protocol_tpu_torch.ops import fieldops2 as f2
    from protocol_tpu_torch.ops import ntt_tpu
    from protocol_tpu_torch.parallel.mesh import psum_scatter
    from protocol_tpu_torch.parallel.ntt import (
        ShardedPlan,
        column_blocks,
        ntt_blocks,
        ntt_sharded,
    )

    k = SHARDED_NTT_K
    plan = ntt_tpu.NttPlan.get(k, device)
    x = f2.upload_mont(_rand_fr_u64(1 << k, 2020), device)
    want = ntt_tpu.ntt(x, plan)
    with tally.count() as launches:
        got = ntt_sharded(x, plan, mesh)
    equal = bool(torch.equal(got, want))
    del got, want
    sp = ShardedPlan(plan, mesh)
    blocks = column_blocks(x, plan.A, plan.B, mesh)
    partials = [torch.zeros(2 * f2.L6 - 1, plan.A, plan.B, dtype=torch.int32,
                            device=device) for _ in range(mesh.size)]
    rec = {"k": k, "shards": mesh.size, "bit_exact": equal,
           "ms": graph_ms(lambda i: ntt_tpu.ntt(x, plan), 2)["ms"],
           "sharded_ms": graph_ms(lambda i: ntt_blocks(blocks, sp), 2)["ms"],
           "psum_scatter_ms": graph_ms(lambda i: psum_scatter(
               partials, mesh, scatter_dim=2), 2)["ms"],
           "launches": launches}
    rec["psum_scatter_share"] = rec["psum_scatter_ms"] / rec["sharded_ms"]
    del sp, blocks, partials, x
    torch.cuda.empty_cache()
    emit("sharded_ntt", **rec)
    check(equal, f"ntt_sharded at 2^{k} differs from ntt")
    return rec


def _sharded_round3(device, mesh, tally) -> dict:
    """``ShardedRound3`` on a resident k = SHARDED_R3_K ``DeviceProver``
    (seeded fixed and σ columns): every column's ext chunk on all four
    cosets (two blinded), the four quotient chunks and the 4n inverse,
    each equal to the ``DeviceProver``'s bit for bit; both pipelines'
    walls."""
    import numpy as np
    import torch

    from protocol_tpu_torch.parallel.prover import ShardedRound3
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
    from protocol_tpu_torch.zk import prover_tpu as ptpu
    from protocol_tpu_torch.zk.plonk import _find_coset_shifts

    k = SHARDED_R3_K
    n = 1 << k
    shift = _find_coset_shifts(4 * n, 2)[1]
    t0 = time.perf_counter()
    dp = ptpu.DeviceProver(k, shift,
                           [_rand_fr_u64(n, 500 + i) for i in range(9)],
                           [_rand_fr_u64(n, 600 + i) for i in range(6)],
                           device=device)
    init_s = time.perf_counter() - t0
    cols = [ptpu.upload_mont(_rand_fr_u64(n, 700 + c), device)
            for c in range(14)]  # 6 wires, z, m, φ, π, u1, u2, v1, v2
    blinds = {6: [12345, 999, 31337], 8: [42, 4242]}  # z and φ blinded
    rng = np.random.default_rng(23)
    beta, gamma, beta_lk, alpha = [int(x) % P for x in
                                   rng.integers(1, 2 ** 62, 4)]
    ch = dp.challenge_planes(beta, gamma, beta_lk, alpha,
                             _find_coset_shifts(n, 6))

    def pipeline(ext, quotient, intt_ext, place):
        c = [place(x) for x in cols]
        t = []
        ext_all = []
        for j in range(4):
            e = [ext(x, j, blinds.get(i)) for i, x in enumerate(c)]
            ext_all.append(e)
            t.append(quotient(j, e[:6], e[6], e[7], e[8], e[9], e[10:], ch))
        return ext_all, t, intt_ext(list(t))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = pipeline(dp.ext_chunk, dp.quotient_chunk, dp.intt_ext,
                    lambda x: x)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    sp = ShardedRound3(dp, mesh)
    with tally.count() as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline(sp.ext_chunk, sp.quotient_chunk, sp.intt_ext,
                       sp.shard)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
    ext_equal = all(torch.equal(sp.gather(g), w)
                    for ge, we in zip(got[0], want[0])
                    for g, w in zip(ge, we))
    quot_equal = all(torch.equal(sp.gather(g), w)
                     for g, w in zip(got[1], want[1]))
    intt_equal = all(torch.equal(sp.gather(g), w)
                     for g, w in zip(got[2], want[2]))
    rec = {"k": k, "shards": mesh.size, "A": dp.A, "B": dp.B,
           "dp_init_s": init_s, "single_s": single_s,
           "sharded_s": sharded_s, "ext_chunk_equal": ext_equal,
           "quotient_chunk_equal": quot_equal, "intt_ext_equal": intt_equal,
           "launches": launches}
    del dp, sp, got, want, cols
    torch.cuda.empty_cache()
    emit("sharded_round3", **rec)
    check(ext_equal, "a sharded ext chunk differs from the DeviceProver's")
    check(quot_equal, "a sharded quotient chunk differs")
    check(intt_equal, "the sharded intt_ext differs")
    return rec


def phase_sharded(device, graph) -> dict:
    """The device mesh (``parallel/``) on a virtual mesh of SHARDED_D
    repeats of the card, every shard running its own kernels: the
    converge graph row-sharded and Clos-routed, and the sharded NTT,
    alone on the card (their times are a virtual mesh's on one card and
    make no claim about scaling). The rest of the slice's checks run
    beside the host-bound phases (``phase_sharded_checks``). Returns the
    phase's record, the sharded calls' launches under ``launches``."""
    from protocol_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[device] * SHARDED_D)
    tally = _Tally()
    rec = {"converge": _sharded_converges(device, graph, mesh, tally),
           "ntt": _sharded_ntt(device, mesh, tally),
           "launches": tally.total, "wall_s": time.perf_counter() - t_phase}
    emit("sharded", shards=mesh.size, launches=tally.total,
         wall_s=rec["wall_s"])
    check(tally.total["lane_perm"] > 0 and tally.total["mont_mul"] > 0,
          f"sharded: B1 or B2 was not launched: {tally.total}")
    return rec


def phase_sharded_checks(device) -> dict:
    """Beside the host-bound phases: the CLI's checkpointed mode on the
    GPU mesh ``make_mesh()`` gives, the lane-sharded ingest and round 3
    on the virtual mesh, and ``entry.dryrun_multichip`` on both. Returns
    the record, the sharded calls' launches under ``launches``."""
    from protocol_tpu_torch.entry import dryrun_multichip
    from protocol_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[device] * SHARDED_D)
    gpu_mesh = make_mesh()
    tally = _Tally()
    rec = {"gpu_mesh_size": gpu_mesh.size,
           "gpu_mesh": [str(d) for d in gpu_mesh.devices],
           "checkpoint": _sharded_checkpoint_cli(tally),
           "ingest": _sharded_ingest(device, mesh, tally),
           "round3": _sharded_round3(device, mesh, tally)}
    dry = {}
    for name, args in (("virtual", (SHARDED_D, [device] * SHARDED_D)),
                       ("gpu", (gpu_mesh.size, None))):
        with tally.count() as launches:
            t0 = time.perf_counter()
            dryrun_multichip(*args)
            dry[name] = {"devices": args[0], "wall_s":
                         time.perf_counter() - t0, "launches": launches}
    rec["dryrun"] = dry
    rec["launches"] = tally.total
    rec["wall_s"] = time.perf_counter() - t_phase
    emit("sharded_checks", gpu_mesh_size=gpu_mesh.size, dryrun=dry,
         launches=tally.total, wall_s=rec["wall_s"])
    for k, v in tally.total.items():
        check(v > 0, f"sharded checks: {k} was not launched")
    return rec


def _moduli() -> dict:
    from protocol_tpu_torch.utils.fields import (
        BN254_FQ_MODULUS,
        BN254_FR_MODULUS,
        SECP256K1_N,
        SECP256K1_P,
    )

    return {"bn254_fr": BN254_FR_MODULUS, "bn254_fq": BN254_FQ_MODULUS,
            "secp256k1_p": SECP256K1_P, "secp256k1_n": SECP256K1_N}


def _field_case(p: int, n: int, rng, lazy: bool):
    """x (lazy sums below 512·p where asked), x reduced, and y, as ints:
    random from the seed, the first lanes the edge values 0, 1, p − 1
    against each other, and the largest lazy sum at lane 9."""
    top = 512 * p if lazy else p
    xs = [rng.getrandbits(264) % top for _ in range(n)]
    ys = [rng.getrandbits(256) % p for _ in range(n)]
    edges = (0, 1, p - 1)
    for i in range(min(n, 9)):
        xs[i], ys[i] = edges[i % 3], edges[i // 3]
    if lazy and n > 9:
        xs[9] = top - 1
    return xs, [x % p for x in xs], ys


def _operand_forms(n: int) -> tuple:
    """The forms a kernel's operands take on the path: rows as made;
    views 88 and 264 bytes into their storage (not on a 16-byte
    boundary: ``x[1:]``, ``y[3:]``); and one row broadcast to all n
    lanes on either side (row stride 0, as ``fieldops.const_rows``
    makes). Each is (name, form of x, form of y, int lane of x, of y)."""
    import torch

    b = n // 2

    def offset(k):  # the rows as a view k rows into a larger tensor
        return lambda t: torch.cat([t.new_zeros(k, t.shape[1]), t])[k:]

    def bcast(t):
        return t[b:b + 1].expand(n, t.shape[1])

    def keep(t):
        return t

    def lane(i):
        return i

    def lane_b(i):
        return b

    return (("as_made", keep, keep, lane, lane),
            ("offset", offset(1), offset(3), lane, lane),
            ("broadcast_x", bcast, keep, lane_b, lane),
            ("broadcast_y", keep, bcast, lane, lane_b))


def phase_field_kernels_vs_plain(device) -> dict:
    """The three field kernels against their plain versions on the card,
    bit for bit, and against Python ints on sampled lanes, at every size
    and operand form; returns the worst |kernel − plain| per kernel."""
    import torch

    from protocol_tpu_torch.ops import fieldops as fo
    from protocol_tpu_torch.ops.kernels import field_kernel as fk

    rng = random.Random(3)
    worst = {"mont_mul": 0, "add_mod": 0, "sub_mod": 0}
    r_bits = fo.LIMB_BITS * fo.NUM_LIMBS
    for name, p in _moduli().items():
        ctx = fo.FieldCtx(p)
        r_inv = pow(1 << r_bits, -1, p)
        checks = 0
        for n in FIELD_SIZES:
            lazy = name == "bn254_fr"
            xs, xc, ys = _field_case(p, n, rng, lazy)
            x = fo.to_device(xs, device)
            x_c = fo.to_device(xc, device)
            y = fo.to_device(ys, device)
            sample = sorted(rng.sample(range(n), min(n, FIELD_SAMPLE)))
            runs = (
                ("mont_mul", x, fk.mont_mul, fk.mont_mul_plain,
                 lambda i, j: xs[i] * ys[j] * r_inv % p),
                ("add_mod", x_c, fk.add_mod, fk.add_mod_plain,
                 lambda i, j: (xc[i] + ys[j]) % p),
                ("sub_mod", x_c, fk.sub_mod, fk.sub_mod_plain,
                 lambda i, j: (xc[i] - ys[j]) % p),
            )
            for form, fx, fy, ix, iy in _operand_forms(n):
                yin = fy(y)
                for kname, xin, kernel, plain, want in runs:
                    xin = fx(xin)
                    if form == "offset":
                        check(xin.data_ptr() % 16 and yin.data_ptr() % 16,
                              "offset operands are on a 16-byte boundary")
                    got = kernel(xin, yin, ctx)
                    torch.cuda.synchronize()
                    ref = plain(xin, yin, ctx)
                    err = int((got.long() - ref.long()).abs().max())
                    worst[kname] = max(worst[kname], err)
                    vals = fo.from_limbs(got[sample].cpu().numpy())
                    check(torch.equal(got, ref), f"{kname} differs from "
                          f"plain ({name}, n={n}, {form} operands)")
                    check(vals == [want(ix(i), iy(i)) for i in sample],
                          f"{kname} differs from Python ints ({name}, "
                          f"n={n}, {form} operands)")
                    checks += 1
        emit("field_kernels_vs_plain", modulus=name, lazy_x=name == "bn254_fr",
             sizes=list(FIELD_SIZES),
             forms=[f[0] for f in _operand_forms(1)],
             sampled_lanes=FIELD_SAMPLE, cases_bit_exact=checks,
             cases_ints_ok=checks)
    return worst


def _int_rate() -> tuple:
    """(32-bit multiply-adds per second, its inputs) of this card: the
    per-SM rate of the CUDA programming guide × SMs × max SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0])
    return (INT_MULADD_PER_CLK_PER_SM * sms * mhz * 1e6,
            {"sms": sms, "max_sm_mhz": mhz,
             "muladd_per_clk_per_sm": INT_MULADD_PER_CLK_PER_SM})


def phase_field_times(device) -> dict:
    """Each field kernel at the path's lane counts: an ingest chunk
    (32,768), N = 512's products (262,144) and the Poseidon MDS step
    (819,200), and at one row, its fixed cost. Device ms per launch from
    CUDA-graph replay with the operands cycling through copies that
    outgrow the L2 (``ms``, held against the bound; the profiler's
    kernel duration beside it) and with the same operands every launch
    (``same_inputs_ms``, L2-warm), beside the host-paced back-to-back ms
    and the plain version."""
    import torch

    from protocol_tpu_torch.ops import fieldops as fo
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P_FR

    ctx = fo.FieldCtx(P_FR)
    int_rate, rate_src = _int_rate()
    rng = random.Random(4)
    kernels = {"mont_mul": (fk.mont_mul, fk.mont_mul_plain, 968),
               "add_mod": (fk.add_mod, fk.add_mod_plain, 22),
               "sub_mod": (fk.sub_mod, fk.sub_mod_plain, 22)}
    out = {}
    for n, launches in FIELD_TIME_SIZES:
        x = fo.to_device([rng.getrandbits(256) % P_FR for _ in range(n)],
                         device)
        y = fo.to_device([rng.getrandbits(256) % P_FR for _ in range(n)],
                         device)
        sets = min(launches,
                   max(2, -(-COLD_BYTES // (2 * x.numel() * 4))))
        xs = [x] + [x.clone() for _ in range(sets - 1)]
        ys = [y] + [y.clone() for _ in range(sets - 1)]
        for name, (kernel, plain, ops_per_lane) in kernels.items():
            nbytes = n * 3 * fo.NUM_LIMBS * 4  # x, y read; out written
            ops = n * ops_per_lane
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / int_rate * 1e3
            cold = graph_ms(
                lambda i: kernel(xs[i % sets], ys[i % sets], ctx), launches,
                profiled=True)
            ms = cold["ms"]
            out[(name, n)] = {
                "kernel": name, "n": n, "ms": ms, "operand_sets": sets,
                "profiler_kernel_ms": cold["kernel_ms"],
                "profiler_events": cold["kernel_events"],
                "same_inputs_ms": graph_ms(lambda i: kernel(x, y, ctx),
                                           launches)["ms"],
                "back_to_back_ms": cuda_ms(lambda: kernel(x, y, ctx),
                                           launches),
                "plain_ms": cuda_ms(lambda: plain(x, y, ctx),
                                    max(5, launches // 20)),
                "bytes": nbytes, "int_ops": ops,
                "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "share_of_bound": max(bytes_ms, ops_ms) / ms,
                "library_ms": None,
            }
        del x, y, xs, ys
        add = out[("add_mod", n)]["ms"]
        for name in kernels:
            rec = out[(name, n)]
            rec["ms_over_add_mod"] = rec["ms"] / add
            emit("field_times", **rec, graph_launches=launches,
                 int_rate=int_rate, **rate_src,
                 library_note="no single PyTorch call computes a "
                 "Montgomery product or a multi-limb modular add")
    return out


def phase_field_converge(device) -> int:
    """field_converge at N = 512, 20 iterations, against a host Python-int
    converge of the same semantics; returns its mont_mul launches."""
    import torch

    from protocol_tpu_torch.ops import fieldops as fo
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P_FR

    rng = random.Random(5)
    n = CONVERGE_N
    zero_rows = set(range(0, n, 37))
    matrix = [[0 if i in zero_rows or i == j else rng.randrange(1000)
               for j in range(n)] for i in range(n)]
    initial = [1000] * n
    ctx = fo.FieldCtx(P_FR)
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.perf_counter()
    got = fo.field_converge(ctx, matrix, initial, CONVERGE_ITERATIONS,
                            device=device)
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)

    t0 = time.perf_counter()
    cols = []
    for row in matrix:
        total = sum(row)
        inv = pow(total, P_FR - 2, P_FR) if total % P_FR else 0
        cols.append([v * inv % P_FR for v in row])
    cols = list(zip(*cols))  # cols[i][j] = norm[j][i]
    s = list(initial)
    for _ in range(CONVERGE_ITERATIONS):
        s = [sum(map(int.__mul__, col, s)) % P_FR for col in cols]
    host_s = time.perf_counter() - t0
    equal = got == s
    emit("field_converge", n=n, iterations=CONVERGE_ITERATIONS,
         zero_rows=len(zero_rows), wall_s=wall, host_oracle_s=host_s,
         launches=launches, equal_to_host=equal,
         score_sum_mod_p=sum(got) % P_FR)
    check(equal, "field_converge at N = 512 differs from the host converge")
    check(launches["mont_mul"] > 0, "field_converge launched no mont_mul")
    return launches["mont_mul"]


def _unliftable_r(rng) -> int:
    from protocol_tpu_torch.crypto.secp256k1 import N, P

    while True:
        r = rng.randrange(1, N)
        rhs = (pow(r, 3, P) + 7) % P
        if pow(rhs, (P + 1) // 4, P) ** 2 % P != rhs:
            return r


def _ingest_fixture(rng):
    """INGEST_DISTINCT attestations by INGEST_SIGNERS signers, signed on
    the host, tiled to INGEST_ATTESTATIONS, and forged lanes of four
    kinds at known indices in every chunk. Returns the attestations, the
    signer index of each honest lane (-1 where forged) and the forged
    lanes by kind."""
    from protocol_tpu_torch.client.attestation import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )
    from protocol_tpu_torch.crypto.secp256k1 import N, EcdsaKeypair

    kps = [EcdsaKeypair(rng.randrange(1, N)) for _ in range(INGEST_SIGNERS)]
    domain = rng.randbytes(20)
    base = []
    for i in range(INGEST_DISTINCT):
        data = AttestationData(
            about=kps[(i * 7 + 1) % INGEST_SIGNERS].public_key
            .to_address_bytes(),
            domain=domain, value=rng.randrange(256),
            message=rng.randbytes(32))
        sig = kps[i % INGEST_SIGNERS].sign(int(data.to_scalar().hash()))
        base.append(SignedAttestationData(data,
                                          SignatureData.from_signature(sig)))
    atts = [base[i % INGEST_DISTINCT] for i in range(INGEST_ATTESTATIONS)]
    signer = [i % INGEST_DISTINCT % INGEST_SIGNERS
              for i in range(INGEST_ATTESTATIONS)]
    bad_r = _unliftable_r(rng)
    forged = {"s_altered": [], "r_at_least_n": [], "r_does_not_lift": [],
              "wrong_parity": []}
    for c in range(INGEST_ATTESTATIONS // INGEST_CHUNK):
        for f, kind in enumerate(forged):
            i = c * INGEST_CHUNK + (100 + 7 * f + c) % INGEST_CHUNK
            a = atts[i]
            sig = a.signature.to_signature()
            r, s, rec = sig.r, sig.s, sig.rec_id
            if kind == "s_altered":
                s = s % (N - 1) + 1 if s != 1 else 2
            elif kind == "r_at_least_n":
                r = N + 7
            elif kind == "r_does_not_lift":
                r = bad_r
            else:
                rec ^= 1
            atts[i] = SignedAttestationData(a.attestation, SignatureData(
                r.to_bytes(32, "big"), s.to_bytes(32, "big"), rec))
            signer[i] = -1
            forged[kind].append(i)
    return atts, signer, forged, [kp.public_key.to_address_bytes()
                                  for kp in kps]


def phase_ingest(device) -> dict:
    """The slice's path: INGEST_ATTESTATIONS signed attestations through
    ``recover_signers_batch`` (pipelined chunks), then one chunk alone,
    with and without ``full_verify``; returns each field kernel's
    launches on the whole run."""
    import numpy as np
    import torch

    from protocol_tpu_torch.client import ingest
    from protocol_tpu_torch.crypto.secp256k1 import recover_public_key
    from protocol_tpu_torch.ops import secp_batch as sb
    from protocol_tpu_torch.ops.kernels import field_kernel as fk

    check(ingest._ingest_chunk() == INGEST_CHUNK,
          "PTPU_INGEST_CHUNK is set; the smoke runs the default chunk")
    rng = random.Random(6)
    t0 = time.perf_counter()
    atts, signer, forged, addrs = _ingest_fixture(rng)
    fixture_s = time.perf_counter() - t0
    addr_set = set(addrs)

    torch.cuda.synchronize()
    fk.reset_launches()
    sb.reset_host_seconds()
    ingest.reset_host_seconds()
    t0 = time.perf_counter()
    pub_keys, addresses, valid = ingest.recover_signers_batch(
        atts, device=device)
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    host = dict(sb.HOST_SECONDS)
    address_s = ingest.HOST_SECONDS["addresses"]
    chunks = INGEST_ATTESTATIONS // INGEST_CHUNK

    # host work of the same call outside the secp stages, timed apart
    t0 = time.perf_counter()
    ingest._att_rows(atts)
    [a.signature.to_signature() for a in atts]
    row_prep_s = time.perf_counter() - t0

    honest_bad = [i for i, k in enumerate(signer)
                  if k >= 0 and not (valid[i] and addresses[i] == addrs[k])]
    forged_report = {}
    for kind, idx in forged.items():
        forged_report[kind] = {
            "lanes": len(idx),
            "mask_false": int(sum(not valid[i] for i in idx)),
            "recovered_a_signer": int(sum(
                bool(valid[i]) and addresses[i] in addr_set for i in idx)),
        }
    host_64 = []
    for i in range(64):  # honest lanes only: forged ones start at 100
        a = atts[i]
        pk = recover_public_key(a.signature.to_signature(),
                                int(a.attestation.to_scalar().hash()))
        host_64.append(pub_keys[i] is not None
                       and pub_keys[i].point == pk.point)

    # one chunk alone (the single-chunk branch), then audited
    head = atts[:INGEST_CHUNK]
    t0 = time.perf_counter()
    _, addr_one, valid_one = ingest.recover_signers_batch(head, device=device)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, valid_audit = ingest.recover_signers_batch(head, full_verify=True,
                                                     device=device)
    audit_s = time.perf_counter() - t0

    rec = {
        "attestations": INGEST_ATTESTATIONS, "chunks": chunks,
        "distinct": INGEST_DISTINCT, "signers": INGEST_SIGNERS,
        "fixture_s": fixture_s, "wall_s": wall,
        "attestations_per_s": INGEST_ATTESTATIONS / wall,
        "wall_s_per_chunk": wall / chunks,
        "host_s": host, "row_prep_s_timed_apart": row_prep_s,
        "address_s": address_s, "address_share": address_s / wall,
        "address_us_per_lane": address_s / INGEST_ATTESTATIONS * 1e6,
        "host_share": (host["limb_prep"] + host["glv_split"] + row_prep_s
                       + address_s) / wall,
        "launches": launches,
        "launches_per_chunk": {k: v / chunks for k, v in launches.items()},
        "honest_lanes_wrong": len(honest_bad), "forged": forged_report,
        "first_64_equal_host": sum(host_64),
        "single_chunk_s": one_s, "single_chunk_full_verify_s": audit_s,
        "single_chunk_mask_equal": bool(np.array_equal(valid_one,
                                                       valid[:INGEST_CHUNK])),
        "full_verify_mask_equal": bool(np.array_equal(valid_audit,
                                                      valid_one)),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("ingest", **rec)
    check(len(valid) == INGEST_ATTESTATIONS, "ingest returned a wrong count")
    check(not honest_bad, f"{len(honest_bad)} honest lanes did not recover "
          "their signer")
    for kind, r in forged_report.items():
        check(r["recovered_a_signer"] == 0,
              f"a forged lane ({kind}) recovered a signer")
    for kind in ("r_at_least_n", "r_does_not_lift"):
        check(forged_report[kind]["mask_false"] == len(forged[kind]),
              f"a forged lane ({kind}) came back valid")
    check(all(host_64), "the first 64 lanes differ from recover_public_key")
    check(rec["single_chunk_mask_equal"] and addr_one == addresses[
        :INGEST_CHUNK], "the single-chunk call differs from the pipelined one")
    check(rec["full_verify_mask_equal"], "full_verify changed the mask")
    for k, v in FIELD_LAUNCHES_PER_CHUNK.items():
        check(launches[k] == v * chunks, f"ingest launched {k} "
              f"{launches[k]} times, not {v} per chunk × {chunks}")
    return launches


def _cli(argv, env=None) -> tuple:
    """One verb of the port's CLI in this process (so the kernel counts
    see its launches): its exit code and what it printed."""
    import contextlib
    import io

    from protocol_tpu_torch.cli.main import main as cli_main

    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main([str(a) for a in argv])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, out.getvalue(), err.getvalue()


def _csv_rows(path: Path) -> list:
    import csv

    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _auto_attestations(keys, domain: bytes) -> list:
    """AUTO_ATTESTATIONS attestations among the four signers: every
    ordered pair rated in rounds with new values, so each pair repeats
    and its latest attestation wins."""
    from protocol_tpu_torch.client import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )

    addrs = [kp.public_key.to_address_bytes() for kp in keys]
    atts = []
    rnd = 0
    while len(atts) < AUTO_ATTESTATIONS:
        for i, kp in enumerate(keys):
            for j, about in enumerate(addrs):
                if i != j and len(atts) < AUTO_ATTESTATIONS:
                    data = AttestationData(about=about, domain=domain,
                                           value=(7 * i + 3 * j + 5 * rnd)
                                           % 256)
                    sig = kp.sign(int(data.to_scalar().hash()))
                    atts.append(SignedAttestationData(
                        data, SignatureData.from_signature(sig)))
        rnd += 1
    return atts


def _setup_key(setup) -> tuple:
    """An ETSetup as comparable values."""
    def ints(xs):
        return tuple(None if x is None else int(x) for x in xs)

    matrix, valid = setup.opinion
    return (tuple(setup.address_set), ints(setup.pub_inputs.scores),
            int(setup.pub_inputs.opinion_hash), tuple(setup.rational_scores),
            tuple(tuple(row) for row in matrix), tuple(valid),
            setup.pub_inputs.to_bytes())


def phase_scores(device) -> dict:
    """The client flow through the port's CLI on the card: ``deploy``,
    four mnemonics ``attest`` each other, ``attestations``, then
    ``scores --backend torch-sparse --batched-ingest`` and ``local-scores
    --backend torch --batched-ingest``, each equal to the exact path's
    scores.csv; ``local-scores --backend torch-sparse --batched-ingest``
    on the port's demo assets, equal to the committed scores.csv; then
    ``Client.et_circuit_setup`` in auto mode on AUTO_ATTESTATIONS
    attestations (repeats, latest wins), which must take the batched
    path (``ingest.*`` spans, no ``ingest.recover_scalar``) and equal
    the scalar path's setup. Returns the field kernels' launches on
    this path (the CLI verbs and the auto-mode setup)."""
    import shutil

    import torch

    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils import trace

    keys = [ecdsa_keypairs_from_mnemonic(m, 1)[0] for m in SCORES_MNEMONICS]
    addrs = ["0x" + kp.public_key.to_address_bytes().hex() for kp in keys]
    domain = bytes(20)
    t0 = time.perf_counter()
    auto_atts = _auto_attestations(keys, domain)
    # the scalar path's setup first: it launches nothing on the card
    config = ClientConfig()
    scalar = _setup_key(Client(config, SCORES_MNEMONICS[0],
                               batched_ingest=False)
                        .et_circuit_setup(auto_atts))
    host_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        flow, demo = Path(d) / "flow", Path(d) / "demo"
        shutil.copytree(ROOT / "protocol_tpu_torch" / "cli" / "assets", demo)
        committed = _csv_rows(demo / "scores.csv")
        rcs = {}
        t0 = time.perf_counter()
        rcs["deploy"] = _cli(["--assets", flow, "deploy"])[0]
        for i, m in enumerate(SCORES_MNEMONICS):
            for j, about in enumerate(addrs):
                if i != j:
                    rcs[f"attest {i}->{j}"] = _cli(
                        ["--assets", flow, "attest", "--to", about,
                         "--score", 10 + 20 * i + 3 * j],
                        env={"MNEMONIC": m})[0]
        rcs["attestations"] = _cli(["--assets", flow, "attestations"])[0]
        rcs["local-scores native"] = _cli(["--assets", flow,
                                           "local-scores"])[0]
        exact = (flow / "scores.csv").read_bytes()
        attest_s = time.perf_counter() - t0

        torch.cuda.synchronize()
        fk.reset_launches()
        walls, same = {}, {}
        for name, argv, path in (
                ("scores torch-sparse", ["--assets", flow, "scores",
                                         "--backend", "torch-sparse",
                                         "--batched-ingest"], flow),
                ("local-scores torch", ["--assets", flow, "local-scores",
                                        "--backend", "torch",
                                        "--batched-ingest"], flow),
                ("demo local-scores torch-sparse",
                 ["--assets", demo, "local-scores", "--backend",
                  "torch-sparse", "--batched-ingest"], demo)):
            (path / "scores.csv").unlink()
            t0 = time.perf_counter()
            rc, out, err = _cli(argv)
            walls[name] = time.perf_counter() - t0
            rcs[name] = rc
            if rc:
                print(err, file=sys.stderr)
            same[name] = (path / "scores.csv").exists() and (
                (path / "scores.csv").read_bytes() == exact
                if path == flow else
                _csv_rows(path / "scores.csv") == committed)
        peers = len(_csv_rows(flow / "scores.csv"))

    # auto mode on the card: the batched path, the scalar path's setup
    trace.TRACER.reset()
    client = Client(config, SCORES_MNEMONICS[0])  # batched_ingest=None
    t0 = time.perf_counter()
    batched = _setup_key(client.et_circuit_setup(auto_atts))
    auto_s = time.perf_counter() - t0
    spans = sorted(trace.summary())
    torch.cuda.synchronize()
    launches = dict(fk.LAUNCHES)
    batched_calls = 4  # three verbs and the auto-mode setup
    emit("scores", rcs=rcs, peers=peers, walls_s=walls,
         equal_to_exact_or_committed=same, attest_flow_s=attest_s,
         auto_attestations=len(auto_atts), auto_mode_s=auto_s,
         auto_spans=spans, auto_setup_equal_scalar=batched == scalar,
         host_setup_s=host_s, launches=launches,
         expected_launches={k: v * batched_calls for k, v in
                            FIELD_LAUNCHES_PER_CHUNK.items()})
    check(all(rc == 0 for rc in rcs.values()), f"a CLI verb failed: {rcs}")
    check(peers == len(SCORES_MNEMONICS), f"scores.csv has {peers} peers")
    check(all(same.values()), f"a scores.csv differs: {same}")
    check("ingest.recover_scalar" not in spans
          and {"ingest.hash_batch", "ingest.recover_batch"} <= set(spans),
          f"auto mode did not take the batched path: {spans}")
    check(batched == scalar, "the batched setup differs from the scalar one")
    for k, v in FIELD_LAUNCHES_PER_CHUNK.items():
        check(launches[k] == v * batched_calls, f"the scores path launched "
              f"{k} {launches[k]} times, not {v} × {batched_calls}")
    return launches


def _compare_reports(routed: dict, sparse: dict, semiring: str) -> dict:
    """Routed against sparse: under maxplus every field but the engine and
    the residual (a float32 sum over slots in another order) must be
    equal and the residual equal within float32 rounding; under plusmul
    iterations within one and mass capture within
    SCENARIO_CAPTURE_RTOL."""
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = v
        return out

    a, b = flat(routed), flat(sparse)
    differ = sorted(k for k in a if a[k] != b.get(k))
    res_rel = (abs(a["scores.residual"] - b["scores.residual"])
               / max(b["scores.residual"], 1e-30))
    it = {k: abs(a[f"scores.{k}"] - b[f"scores.{k}"])
          for k in ("iterations", "baseline_iterations")}
    cap = {k: abs(a[f"robustness.{k}"] - b[f"robustness.{k}"])
           / max(b[f"robustness.{k}"], 1e-30)
           for k in ("attacker_mass_capture", "baseline_attacker_mass")}
    if semiring == "maxplus":
        ok = (set(differ) <= {"engine", "scores.residual"}
              and res_rel <= 1e-5)
    else:
        ok = (max(it.values()) <= 1
              and max(cap.values()) <= SCENARIO_CAPTURE_RTOL)
    return {"ok": ok, "fields_differing": differ,
            "residual_rel_diff": res_rel, "iterations_diff": it,
            "capture_rel_diff": cap}


def phase_scenario(device) -> int:
    """``scenario run --topology sybil-ring --peers SCENARIO_PEERS --seed 7
    --engine routed --timing`` through the CLI, once per semiring, each
    held against the same run with ``--engine sparse``; the lane_perm
    launches of each routed run must equal (edge-route stages +
    state-route stages) of each operator it built × the sweeps run on
    it. Returns the launches of both routed runs."""
    import torch

    from protocol_tpu_torch import graph as graph_mod
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops import routed as routed_mod

    # each backend builds its operator inside its converge: record the
    # routed plans (their stage counts) and both engines' build seconds
    built, gather_builds = [], []
    build = routed_mod.build_routed_operator
    build_gather = graph_mod.build_operator

    def recording_build(*args, **kwargs):
        t0 = time.perf_counter()
        op = build(*args, **kwargs)
        built.append((op, time.perf_counter() - t0))
        return op

    def recording_gather_build(*args, **kwargs):
        t0 = time.perf_counter()
        op = build_gather(*args, **kwargs)
        gather_builds.append(time.perf_counter() - t0)
        return op

    base = ["scenario", "run", "--topology", "sybil-ring", "--peers",
            SCENARIO_PEERS, "--seed", SCENARIO_SEED, "--timing"]
    total, results = 0, {}
    for semiring in ("plusmul", "maxplus"):
        reports = {}
        for engine in ("routed", "sparse"):
            built.clear()
            gather_builds.clear()
            routed_mod.build_routed_operator = recording_build
            graph_mod.build_operator = recording_gather_build
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            try:
                rc, out, err = _cli([*base, "--semiring", semiring,
                                     "--engine", engine])
            finally:
                routed_mod.build_routed_operator = build
                graph_mod.build_operator = build_gather
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.LAUNCHES["lane_perm"]
            if rc:
                print(err, file=sys.stderr)
            check(rc == 0, f"scenario run --engine {engine} --semiring "
                  f"{semiring} failed")
            rep = json.loads(out)
            reports[engine] = rep
            ops = [{"edge_stages": len(op.edge_stages),
                    "state_stages": len(op.state_stages),
                    "filtered_edges": int(op.nnz), "plan_build_s": s}
                   for op, s in built]
            sweeps = [rep["scores"]["iterations"],
                      rep["scores"]["baseline_iterations"]]
            expected = sum((o["edge_stages"] + o["state_stages"]) * n
                           for o, n in zip(ops, sweeps))
            timing = rep["timing_s"]
            builds = [o["plan_build_s"] for o in ops] or list(gather_builds)
            converge_s = [timing["attack_converge"] - builds[0],
                          timing["baseline_converge"] - builds[1]]
            results[f"{semiring}_{engine}"] = {
                "wall_s": wall, "timing_s": timing,
                "operator_build_s": builds,
                "converge_s_without_operator_build": converge_s,
                "edges": rep["edges"], "attackers": rep["attackers"],
                "iterations": sweeps, "residual": rep["scores"]["residual"],
                "capture": rep["robustness"]["attacker_mass_capture"],
                "baseline_capture":
                    rep["robustness"]["baseline_attacker_mass"],
                "rank_displacement":
                    rep["robustness"]["honest_rank_displacement"],
                "attackers_in_top": rep["robustness"]["attackers_in_top"],
                "operators": ops, "lane_perm_launches": launches,
                "expected_launches": expected}
            if engine == "routed":
                check(len(ops) == 2, f"the routed run built {len(ops)} "
                      "operators, not the attack's and the baseline's")
                check(launches == expected, f"lane_perm launched {launches}"
                      f" times under {semiring}, expected {expected}")
                total += launches
            else:
                check(launches == 0 and not ops,
                      "the sparse engine ran the routed path")
        for rep in reports.values():
            rep.pop("timing_s")
        results[f"{semiring}_agreement"] = _compare_reports(
            reports["routed"], reports["sparse"], semiring)
    emit("scenario", peers=SCENARIO_PEERS, seed=SCENARIO_SEED,
         topology="sybil-ring", **results)
    for semiring in ("plusmul", "maxplus"):
        check(results[f"{semiring}_agreement"]["ok"], f"routed and sparse "
              f"reports disagree under {semiring}: "
              f"{results[f'{semiring}_agreement']}")
    return total


def _http(url: str, path: str, timeout: float = 120.0):
    """GET one route of a daemon: JSON, or the text of ``/metrics``."""
    import urllib.request

    with urllib.request.urlopen(url + path, timeout=timeout) as r:
        body = r.read()
    return body.decode() if path == "/metrics" else json.loads(body)


def _series(text: str, name: str, **labels):
    """Sum of every series of one metric family on a ``/metrics`` page
    whose labels include ``labels`` (span names are exported with their
    dots as underscores); None when there is none."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    total, seen = 0.0, False
    for line in text.splitlines():
        if line.startswith(name) and line[len(name):len(name) + 1] in " {" \
                and all(w in line for w in want):
            total += float(line.split()[-1])
            seen = True
    return total if seen else None


def _wait_for(pred, what: str, timeout: float = SERVE_TIMEOUT_S) -> float:
    t0 = time.perf_counter()
    limit = _left(timeout)
    while not pred():
        check(time.perf_counter() - t0 < limit,
              f"timed out after {limit:.0f} s: {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def _serve_seed(state_dir: Path, peers: int, rng) -> tuple:
    """A state dir at ``peers`` peers: the filtered BA graph as one
    format-2 snapshot written by the daemon's own codec, the first
    SERVE_SIGNERS ids the mnemonic's signers, the rest seeded addresses,
    no published table (the first refresh is cold) and an empty WAL."""
    import numpy as np

    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic
    from protocol_tpu_torch.graph import barabasi_albert_edges, filter_edges
    from protocol_tpu_torch.service.refresh import ScoreTable
    from protocol_tpu_torch.store import StateStore, encode_service_state

    keys = ecdsa_keypairs_from_mnemonic(SCORES_MNEMONICS[0], SERVE_SIGNERS)
    addrs = [kp.public_key.to_address_bytes() for kp in keys]
    taken = set(addrs)
    while len(addrs) < peers:
        a = rng.bytes(20)
        if a not in taken:
            taken.add(a)
            addrs.append(a)
    src, dst, val = barabasi_albert_edges(peers, BA_M, seed=SERVE_SEED)
    fsrc, fdst, _, _, _, raw, _ = filter_edges(peers, src, dst, val, None,
                                               return_raw=True)
    store = StateStore(str(state_dir))
    empty = ScoreTable((), np.zeros(0), -1, 0, 0.0, True, 0.0)
    arrays, meta = encode_service_state(addrs, fsrc, fdst, raw, 1, 0, 0,
                                        empty, store.wal.position())
    store.snapshots.save(1, arrays, meta)
    store.close()
    return keys, addrs, fsrc, fdst


def _serve_churn(keys, addrs, fsrc, fdst, rng, domain: bytes,
                 waves: int = SERVE_WAVES) -> list:
    """``waves`` waves of signed attestations: each signer revises
    SERVE_REVISIONS of its edges in the snapshot and attests one peer it
    has no edge to. Returns per wave ``[(signer id, signed), ...]``."""
    import numpy as np

    from protocol_tpu_torch.client import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )

    n = len(addrs)
    out = []
    for _ in range(waves):
        wave = []
        for i, kp in enumerate(keys):
            lo, hi = np.searchsorted(fsrc, [i, i + 1])
            nbrs = set(int(x) for x in fdst[lo:hi])
            about = list(rng.choice(sorted(nbrs), SERVE_REVISIONS,
                                    replace=False))
            new = int(rng.integers(SERVE_SIGNERS, n))
            while new in nbrs:
                new = int(rng.integers(SERVE_SIGNERS, n))
            for j in [*about, new]:
                data = AttestationData(about=addrs[int(j)], domain=domain,
                                       value=int(rng.integers(1, 11)))
                sig = kp.sign(int(data.to_scalar().hash()))
                wave.append((i, SignedAttestationData(
                    data, SignatureData.from_signature(sig))))
        out.append(wave)
    return out


def _save_local_chain(path: Path, chain) -> None:
    """The chain file the daemon tails, replaced in one rename so a poll
    never reads half of it."""
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(chain.to_json()))
    os.replace(tmp, path)


def _rung(before: dict, after: dict) -> str:
    """The lowest ladder rung that served a refresh between two reads of
    the refresher's counters."""
    moved = {k for k in after if after[k] != before[k]}
    for rung in ("device_partial", "sampled", "partial", "full"):
        if rung in moved:
            return rung
    return "rebuild" if "refreshes" in moved else "none"


def _rung_counters(r) -> dict:
    return {"partial": r.partial_refreshes - r.device_partial_refreshes
            - r.sampled_refreshes,
            "device_partial": r.device_partial_refreshes,
            "sampled": r.sampled_refreshes, "full": r.full_sweeps,
            "refreshes": r.refreshes}


class _Child:
    """A process the smoke starts: its stdout and stderr go to files in
    ``d`` (a pipe that nobody drains fills up and blocks the child), its
    output unbuffered."""

    def __init__(self, argv, d, name: str, env: dict):
        self.out_path = Path(d) / f"{name}.stdout"
        self.err_path = Path(d) / f"{name}.stderr"
        with open(self.out_path, "w") as out, open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [str(a) for a in argv], stdout=out, stderr=err, cwd=ROOT,
                env=dict(env, PYTHONUNBUFFERED="1"))

    def first_line(self, timeout: float) -> str:
        """The child's first line of stdout, or what it printed when it
        exited or the time ran out."""
        t0 = time.perf_counter()
        limit = _left(timeout)
        while True:
            text = self.out_path.read_text()
            if "\n" in text:
                return text.split("\n", 1)[0]
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > limit:
                return text
            time.sleep(0.05)

    def finish(self, timeout: float, what: str) -> tuple:
        """Wait for the child's exit: ``(stdout, stderr)``."""
        try:
            self.proc.wait(timeout=_left(timeout))
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"timed out: {what}") from None
        return self.out_path.read_text(), self.err_path.read_text()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _http_raw(url: str, path: str, headers=None, data=None,
              timeout: float = 120.0) -> tuple:
    """``(status, headers, body)`` of one request; an HTTP error status
    (304, 503) is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + path, data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _score_map(url: str) -> dict:
    return {r["address"]: r["score"] for r in _http(url, "/scores")["scores"]}


def _max_rel(a: dict, b: dict) -> float:
    """Worst ``|a - b| / max(|b|, 1)`` over ``b``'s keys (``a`` must
    hold them all)."""
    return max(abs(a[k] - v) / max(abs(v), 1.0) for k, v in b.items())


def _follower_caught_up(fol, svc) -> bool:
    """The follower holds the leader's committed WAL and published a
    table of its own latest revision; the leader published its own."""
    return (fol._cursor == tuple(svc.store.wal.committed_position())
            and fol.last_backlog == 0
            and fol.refresher.table.revision == fol.graph.revision
            and svc.refresher.table.revision == svc.graph.revision)


def _serve_follower(device, svc, url: str, d: str, chain_path: Path,
                    chain, keys, addrs, fsrc, fdst, rng,
                    posted: int) -> tuple:
    """A read replica of the live leader, on the card, built as ``serve
    --follow`` builds it (``batched_ingest=None``, the default device):
    it bootstraps from the leader's seeded snapshot and catches up on
    the shipped WAL (the four waves, one batched recovery and the cold
    routed refresh, then the delta engine); the launch counts are then
    the follower's alone. One live wave reaches both daemons. The
    follower is held to: its scores within SERVE_SCORE_RTOL of a
    float64 gather converge over its own edge set and of the leader's at
    the same WAL position, lag 0, the leader's ``/bundle`` byte for byte
    with a 304, ``POST /proofs`` 503, one full build; ``fleet``, ``slo``
    and ``incident`` through the CLI against the pair; then a drain and a
    ``serve --follow`` restart that resumes from its cursor with the same
    scores and drains on SIGTERM. Returns ``(record, launches, the
    attestations posted in all)``."""
    import signal

    import numpy as np
    import torch

    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.client import ClientConfig
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.service import FollowerService, ServiceConfig
    from protocol_tpu_torch.utils import trace

    on_card = device.type == "cuda"
    res: dict = {}
    fstate = Path(d) / "follower-state"
    fconfig = ServiceConfig(port=0, poll_interval=0.05,
                            refresh_interval=0.05)
    domain = bytes.fromhex(ClientConfig().domain[2:])
    batches0 = trace.summary().get("ingest.recover_batch", {}).get("count", 0)
    if on_card:
        torch.cuda.synchronize()
    kernels.reset_launches()
    fk.reset_launches()
    t0 = time.perf_counter()
    fol = FollowerService(url, domain, fconfig, str(fstate),
                          batched_ingest=None,
                          device=None if on_card else device)
    proc = None
    try:
        furl = fol.start()
        _wait_for(lambda: fol._cursor is not None, "the follower's bootstrap")
        res["bootstrap_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        _wait_for(lambda: _follower_caught_up(fol, svc),
                  "the follower's catch-up")
        res["catch_up_s"] = time.perf_counter() - t1
        if on_card:
            torch.cuda.synchronize()
        launches = {"lane_perm": kernels.LAUNCHES["lane_perm"],
                    **{k: fk.LAUNCHES[k] for k in
                       ("mont_mul", "add_mod", "sub_mod")}}
        res["launches"] = launches
        res["records"] = fol.records_applied
        res["recover_batches"] = trace.summary().get(
            "ingest.recover_batch", {}).get("count", 0) - batches0
        res["caught_up_table"] = {
            "cold": fol.refresher.table.cold,
            "iterations": fol.refresher.table.iterations,
            "refreshes": fol.refresher.refreshes,
            "operator_builds": fol.refresher.operator_builds}
        check(fol.records_applied == posted and fol.graph.invalid == 0,
              f"the follower applied {fol.records_applied} of {posted} "
              f"records, {fol.graph.invalid} invalid")
        check(res["recover_batches"] >= 1,
              "the follower did not recover its signers in batch")
        check(fol.refresher.operator_builds == 1
              and fol.refresher.delta_engine is not None,
              "the follower's first refresh was not one routed build with "
              "the delta engine anchored on it")

        # one live wave: both daemons absorb it
        config = ClientConfig()
        (wave,) = _serve_churn(keys, addrs, fsrc, fdst, rng,
                               bytes.fromhex(config.domain[2:]),
                               waves=SERVE_LIVE_WAVES)
        for i, signed in wave:
            att = signed.attestation
            chain.attest(addrs[i], [(att.about, att.get_key(),
                                     signed.to_payload())])
        posted += len(wave)
        done = {"leader": lambda: svc.tailer.attestations >= posted
                and svc.refresher.table.revision == svc.graph.revision,
                "follower": lambda: fol.records_applied >= posted
                and fol.last_backlog == 0
                and fol.refresher.table.revision == fol.graph.revision}
        published: dict = {}
        t1 = time.perf_counter()
        _save_local_chain(chain_path, chain)
        while len(published) < len(done):  # both clocks from the post
            for who, pred in done.items():
                if who not in published and pred():
                    published[who] = time.perf_counter() - t1
            check(time.perf_counter() - t1 < SERVE_TIMEOUT_S,
                  f"timed out: the live wave ({sorted(published)} done)")
            time.sleep(0.005)
        _wait_for(lambda: _follower_caught_up(fol, svc),
                  "the follower's live wave")
        res["live_wave"] = {"attestations": len(wave),
                            "leader_published_s": published["leader"],
                            "follower_published_s": published["follower"],
                            "lag_s": published["follower"]
                            - published["leader"]}
        check(fol.records_applied == posted,
              f"the follower holds {fol.records_applied} of {posted}")
        check(fol.refresher.operator_builds == 1,
              f"{fol.refresher.operator_builds} full builds on the "
              "follower: churn after its first refresh rebuilt the operator")

        # scores: the float64 gather reference over its own edges, and
        # the leader's at the same WAL position
        n, src, dst, val, revision, _ = fol.graph.snapshot()
        check(revision == fol.refresher.table.revision,
              "the follower's table trails its graph")
        ref, _, _ = TorchSparseBackend(
            dtype=torch.float64, device=device).converge_edges(
            n, src, dst, val, np.ones(n, dtype=bool),
            fconfig.initial_score, fconfig.max_iterations, tol=fconfig.tol,
            alpha=fconfig.alpha)
        ref_map = {"0x" + a.hex(): float(ref[i])
                   for i, a in enumerate(fol.graph.addresses())}
        got = _score_map(furl)
        lead = _score_map(url)
        check(set(got) == set(ref_map) == set(lead),
              "the follower, its reference and the leader hold other peers")
        res["served_max_rel_err"] = _max_rel(got, ref_map)
        res["leader_max_rel_diff"] = _max_rel(got, lead)
        check(res["served_max_rel_err"] <= SERVE_SCORE_RTOL,
              f"a follower score is {res['served_max_rel_err']} relative "
              "from the float64 reference")
        check(res["leader_max_rel_diff"] <= SERVE_SCORE_RTOL,
              f"a follower score is {res['leader_max_rel_diff']} relative "
              "from the leader's")
        lag = _series(_http(furl, "/metrics"), "ptpu_repl_lag_records")
        res["repl_lag_records"] = lag
        check(lag == 0.0, f"ptpu_repl_lag_records reads {lag}")
        # the leader's bundle, verbatim (revalidated at most once a
        # second on an eof poll), and its 304
        _wait_for(lambda: _http_raw(furl, "/bundle")[2]
                  == _http_raw(url, "/bundle")[2],
                  "the leader's bundle on the follower", timeout=30.0)
        _, headers, _ = _http_raw(furl, "/bundle")
        status = _http_raw(furl, "/bundle",
                           headers={"If-None-Match": headers["ETag"]})[0]
        check(status == 304, f"/bundle If-None-Match answered {status}")
        status = _http_raw(furl, "/proofs", data=b'{"kind": "eigentrust"}',
                           headers={"Content-Type": "application/json"})[0]
        check(status == 503, f"POST /proofs on the follower answered {status}")

        # the operator verbs against the live pair
        _wait_for(lambda: {r["role"] for r in _http(url, "/fleet")[
            "instances"] if r.get("active")} >= {"leader", "follower"},
            "the follower's row on /fleet", timeout=60.0)
        rc, text, err = _cli(["fleet", "--url", url])
        roles = {ln.split()[1]: ln.split()[2]
                 for ln in text.splitlines()[2:] if len(ln.split()) > 2}
        res["fleet"] = text.splitlines()
        check(rc == 0 and roles.get("leader") == "up"
              and roles.get("follower") == "up",
              f"fleet lists {roles}: {err}")
        rc, text, err = _cli(["slo", "--url", furl, "--json"])
        res["slo_alerting"] = json.loads(text).get("alerting")
        check(rc in (0, 1), f"slo --json failed: {err}")
        inc = json.loads(_http_raw(url, "/incidents/capture", data=b"{}",
                                   headers={"Content-Type":
                                            "application/json"})[2])
        rc, text, err = _cli(["incident", "--url", url])
        check(rc == 0 and inc["id"] in text, f"incident lists {text!r}")
        rc, text, err = _cli(["incident", "--url", url, "--id", inc["id"]])
        res["autopsy_lines"] = len(text.splitlines())
        check(rc == 0 and text.startswith(f"incident {inc['id']}\n"),
              f"incident --id {inc['id']} rendered {text[:200]!r}: {err}")
        # "latest" is the newest capture: ours, or one the leader's own
        # watchdog took after it
        rc, text, err = _cli(["incident", "--url", url, "--id", "latest"])
        check(rc == 0 and text.startswith("incident inc-"),
              f"incident --id latest rendered {text[:200]!r}: {err}")

        before = got
        cursor = fol._cursor
        t1 = time.perf_counter()
        clean = fol.shutdown()
        res["drain_s"] = time.perf_counter() - t1
        check(clean, "the follower's drain was not clean")

        # restart through the CLI on the same state dir
        stream = Path(d) / "follower-restart.jsonl"
        env = dict(os.environ, PROTOCOL_TPU_TRACE=str(stream),
                   PYTHONPATH=str(ROOT))
        argv = [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets",
                d, "serve", "--follow", url, "--port", "0", "--state-dir",
                str(fstate), "--device", "cuda" if on_card else "cpu"]
        t1 = time.perf_counter()
        proc = _Child(argv, d, "follower-restart", env)
        line = proc.first_line(SERVE_TIMEOUT_S)
        res["restart_to_listening_s"] = time.perf_counter() - t1
        check("FOLLOWER listening on http://" in line,
              f"the restarted follower did not come up: {line!r}")
        furl2 = line.split("listening on ")[1].split()[0]
        st = _http(furl2, "/status")
        check(st["repl"]["cursor"] == "%d:%d" % cursor,
              f"the restart resumed at {st['repl']['cursor']}, not "
              f"{cursor}")
        after = _score_map(furl2)
        check(set(after) == set(before), "the restart serves other peers")
        res["restart_max_rel_err"] = _max_rel(after, before)
        check(res["restart_max_rel_err"] <= SERVE_RESTART_RTOL,
              f"restarted follower scores differ by "
              f"{res['restart_max_rel_err']}")
        proc.proc.send_signal(signal.SIGTERM)
        out, err = proc.finish(SERVE_TIMEOUT_S, "the follower's drain")
        check(proc.proc.returncode == 0 and "follower drained" in out,
              f"the restarted follower exited {proc.proc.returncode}: "
              f"{err[-2000:]}")
        names = [json.loads(ln).get("name") for ln in
                 stream.read_text().splitlines()]
        check("follower.restored" in names
              and "follower.bootstrapped" not in names
              and "follower.bootstrap_empty" not in names,
              "the restarted follower bootstrapped again")
        res["restart_s"] = time.perf_counter() - t1
    finally:
        fol.shutdown()
        if proc is not None:
            proc.stop()
    return res, launches, posted


def phase_serve(device, peers: int = SERVE_PEERS) -> dict:
    """The trust-scores daemon on the card, at ``peers`` peers: seed a
    state dir (one format-2 snapshot of the filtered BA graph), build
    ``TrustService`` in process on the default device with the
    ``serve`` verb's client (``batched_ingest=None``) and the default
    thresholds and tolerances, time the restore and the first, cold
    routed refresh (the plan build apart), post SERVE_WAVES waves of
    signed attestations through the local chain file the daemon tails
    (each wave one poll, so the sink recovers its signers on the field
    kernels), and hold the daemon to: every served score of the signers
    and of SERVE_CHECKED seeded peers within SERVE_SCORE_RTOL of a
    float64 gather converge over its own edge set, no full build across
    the churn, the exposition lint on ``/metrics``, the ``/status``
    keys, and B1 and the three field kernels launched on this path.
    Then drain it, restart it through ``python -m protocol_tpu_torch.cli
    serve`` on the same state dir (the startup compaction folds the WAL
    and recovers its signers on the card once more), hold its
    ``/scores`` to the values before the stop within SERVE_RESTART_RTOL
    and ``store inspect``'s counts to its ``/status``, and SIGTERM it."""
    import signal

    import numpy as np
    import torch

    from protocol_tpu_torch.backend import TorchSparseBackend
    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.client import Client, ClientConfig, LocalChain
    from protocol_tpu_torch.ops import kernels
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.service import ServiceConfig, TrustService
    from protocol_tpu_torch.service.metrics import lint_exposition
    from protocol_tpu_torch.service.tailer import FileBackedLocalChain
    from protocol_tpu_torch.utils import trace

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SERVE_SEED)
    res: dict = {"peers": peers}
    proc = None
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        files = EigenFile(Path(d))
        state = files.service_state_dir()
        t0 = time.perf_counter()
        keys, addrs, fsrc, fdst = _serve_seed(state, peers, rng)
        res["seed_s"] = time.perf_counter() - t0
        res["edges"] = int(len(fsrc))
        t0 = time.perf_counter()
        config = ClientConfig()
        waves = _serve_churn(keys, addrs, fsrc, fdst, rng,
                             bytes.fromhex(config.domain[2:]))
        res["sign_s"] = time.perf_counter() - t0
        (files.assets / "config.json").write_text(json.dumps(
            config.to_dict()))
        chain = LocalChain()
        _save_local_chain(files.chain_json(), chain)
        # the serve verb's wiring: batched_ingest=None (the auto rule),
        # the default device, the file-persisted local chain
        client = Client(config, SCORES_MNEMONICS[0], batched_ingest=None,
                        device=None if on_card else device)
        client.chain = FileBackedLocalChain(files.chain_json())
        svc_config = ServiceConfig(
            port=0, poll_interval=0.05, refresh_interval=0.05,
            snapshot_every=SERVE_LEADER_SNAPSHOT_EVERY)
        trace.TRACER.reset()
        if on_card:
            torch.cuda.synchronize()
        kernels.reset_launches()
        fk.reset_launches()
        t0 = time.perf_counter()
        svc = TrustService(client, svc_config, str(state / "cursor"),
                           files=files, state_dir=str(state))
        res["restore_s"] = time.perf_counter() - t0
        check(svc.graph.n == peers and svc.graph.n_edges == len(fsrc),
              f"restored {svc.graph.n} peers and {svc.graph.n_edges} "
              "edges, not the seeded graph")
        try:
            url = svc.start()
            t0 = time.perf_counter()
            _wait_for(lambda: svc.refresher.table.revision
                      == svc.graph.revision, "the cold refresh")
            res["cold_refresh_s"] = time.perf_counter() - t0
            spans = trace.summary()
            res["plan_build_s"] = spans["routed.plan_build"]["total_s"]
            res["delta_anchor_s"] = spans["service.delta_anchor"]["total_s"]
            table = svc.refresher.table
            res["cold"] = {"iterations": table.iterations,
                           "delta": table.delta, "cold": table.cold}
            check(table.cold and svc.refresher.operator_builds == 1
                  and svc.refresher.delta_engine is not None,
                  "the first refresh was not one cold routed build with "
                  "the delta engine anchored on it")
            builds0 = _series(_http(url, "/metrics"),
                              "ptpu_operator_full_builds_total")

            posted, wave_res = 0, []
            for wave in waves:
                for i, signed in wave:
                    att = signed.attestation
                    chain.attest(addrs[i], [(att.about, att.get_key(),
                                             signed.to_payload())])
                before = _rung_counters(svc.refresher)
                sink0 = trace.summary().get("service.tail_batch", {})
                posted += len(wave)
                t0 = time.perf_counter()
                _save_local_chain(files.chain_json(), chain)
                _wait_for(lambda: svc.tailer.attestations >= posted,
                          "the wave's ingest")
                ingest_s = time.perf_counter() - t0
                _wait_for(lambda: svc.refresher.table.revision
                          == svc.graph.revision, "the wave's refresh")
                sink1 = trace.summary()["service.tail_batch"]
                wave_res.append({
                    "attestations": len(wave), "ingest_wall_s": ingest_s,
                    "sink_s": sink1["total_s"] - sink0.get("total_s", 0.0),
                    "to_published_s": time.perf_counter() - t0,
                    "rung": _rung(before, _rung_counters(svc.refresher)),
                    "iterations": svc.refresher.table.iterations})
            if on_card:
                torch.cuda.synchronize()
            launches = {"lane_perm": kernels.LAUNCHES["lane_perm"],
                        **{k: fk.LAUNCHES[k] for k in
                           ("mont_mul", "add_mod", "sub_mod")}}
            spans = trace.summary()
            res["waves"] = wave_res
            res["sink_s"] = spans["service.tail_batch"]["total_s"]
            res["recover_s"] = spans["service.ingest"]["total_s"]
            res["ingest_att_per_s"] = posted / res["sink_s"]
            res["recover_att_per_s"] = posted / res["recover_s"]
            res["snapshots_during_churn"] = spans.get(
                "service.snapshot", {}).get("count", 0)
            res["warm_refresh_s"] = [
                w["to_published_s"] - w["ingest_wall_s"] for w in wave_res]
            res["launches"] = launches
            res["spans"] = sorted(spans)
            check(svc.tailer.attestations == posted
                  and svc.graph.invalid == 0,
                  f"ingested {svc.tailer.attestations} of {posted} "
                  f"attestations, {svc.graph.invalid} invalid")
            check("service.recover_scalar" not in spans
                  and "ingest.recover_batch" in spans,
                  "the sink did not recover its signers in batch")

            metrics = _http(url, "/metrics")
            builds1 = _series(metrics, "ptpu_operator_full_builds_total")
            res["full_builds"] = [builds0, builds1]
            check(builds1 == builds0, f"full builds moved under churn: "
                  f"{builds0} -> {builds1}")
            check(svc.refresher.delta_batches >= SERVE_WAVES,
                  f"{svc.refresher.delta_batches} churn windows absorbed")
            errors = lint_exposition(metrics)
            check(not errors, "scrape lint failed: " + "; ".join(errors[:5]))
            needles = ["ptpu_http_request_seconds_bucket",
                       "ptpu_wal_append_seconds_bucket",
                       "ptpu_score_freshness_seconds",
                       "ptpu_refresh_seconds_bucket",
                       "ptpu_service_ingest_attestations_total",
                       "ptpu_span_total"]
            if on_card:
                needles.append("ptpu_device_bytes_in_use")
            missing = [n for n in needles if n not in metrics]
            check(not missing, f"/metrics misses {missing}")
            res["metrics_lines"] = len(metrics.splitlines())
            status = _http(url, "/status")
            missing = [k for k in ("uptime_seconds", "block_cursor", "graph",
                                   "score_freshness_seconds",
                                   "last_refresh", "queue")
                       if k not in status]
            check(not missing, f"/status misses {missing}")
            fresh = status["score_freshness_seconds"]
            check(status["graph"]["peers"] == peers
                  and 0.0 <= fresh < 120.0,
                  f"/status graph {status['graph']}, freshness {fresh}")
            res["status"] = {k: status[k] for k in ("graph", "last_refresh",
                                                    "delta")}

            # the served scores against a float64 gather converge over
            # the daemon's own edge set, on the same device
            n, src, dst, val, revision, _ = svc.graph.snapshot()
            check(revision == svc.refresher.table.revision,
                  "the table trails the graph")
            t0 = time.perf_counter()
            ref, ref_iters, ref_delta = TorchSparseBackend(
                dtype=torch.float64, device=device).converge_edges(
                n, src, dst, val, np.ones(n, dtype=bool),
                svc_config.initial_score, svc_config.max_iterations,
                tol=svc_config.tol, alpha=svc_config.alpha)
            res["reference"] = {"iterations": ref_iters, "delta": ref_delta,
                                "s": time.perf_counter() - t0}
            ids = list(range(SERVE_SIGNERS)) + sorted(
                int(x) for x in rng.choice(np.arange(SERVE_SIGNERS, n),
                                           SERVE_CHECKED, replace=False))
            worst = 0.0
            for i in ids:
                got = _http(url, f"/score/0x{addrs[i].hex()}")["score"]
                worst = max(worst, abs(got - ref[i]) / max(abs(ref[i]), 1.0))
            res["served_max_rel_err"] = worst
            res["served_checked"] = len(ids)
            check(worst <= SERVE_SCORE_RTOL, f"a served score is {worst} "
                  "relative from the float64 reference")
            follower, follower_launches, posted = _serve_follower(
                device, svc, url, d, files.chain_json(), chain, keys, addrs,
                fsrc, fdst, rng, posted)
            res["follower"] = follower
            before = _http(url, "/scores")
        finally:
            t0 = time.perf_counter()
            clean = svc.shutdown()
            res["drain_s"] = time.perf_counter() - t0
        check(clean, "the drain was not clean")

        # restart through the CLI: the startup compaction (one segment is
        # enough) folds the WAL and recovers its signers on the card
        stream = Path(d) / "restart.jsonl"
        env = dict(os.environ, PTPU_SERVE_WAL_COMPACT_SEGMENTS="1",
                   PROTOCOL_TPU_TRACE=str(stream), PYTHONPATH=str(ROOT))
        argv = [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets",
                d, "serve", "--port", "0", "--state-dir", str(state)]
        if not on_card:
            argv += ["--device", "cpu"]
        t0 = time.perf_counter()
        proc = _Child(argv, d, "restart", env)
        try:
            line = proc.first_line(SERVE_TIMEOUT_S)
            res["restart_to_listening_s"] = time.perf_counter() - t0
            check("listening on http://" in line,
                  f"the restarted daemon did not come up: {line!r}")
            url2 = line.split("listening on ")[1].split()[0]
            after = _http(url2, "/scores")
            status2 = _http(url2, "/status")
            metrics2 = _http(url2, "/metrics")
            b = {r["address"]: r["score"] for r in before["scores"]}
            a = {r["address"]: r["score"] for r in after["scores"]}
            check(set(a) == set(b) and len(a) == peers,
                  "the restarted daemon serves another peer set")
            worst = max(abs(a[k] - v) / max(abs(v), 1.0) for k, v in b.items())
            res["restart_max_rel_err"] = worst
            check(worst <= SERVE_RESTART_RTOL,
                  f"restarted scores differ by {worst} relative")
            recovered = _series(metrics2, "ptpu_span_total",
                                span="ingest_recover_batch")
            res["restart"] = {
                "replayed_records": status2["store"]["replayed_records"],
                "wal_compact_s": _series(metrics2, "ptpu_span_seconds_total",
                                         span="service_wal_compact"),
                "recover_batch_spans": recovered,
                "recover_batch_s": _series(metrics2,
                                           "ptpu_span_seconds_total",
                                           span="ingest_recover_batch"),
                "scalar_spans": _series(metrics2, "ptpu_span_total",
                                        span="service_recover_scalar")}
            check(recovered and not res["restart"]["scalar_spans"],
                  f"the restart did not recover in batch: {res['restart']}")
            rc, text, err = _cli(["--assets", d, "store", "inspect",
                                  "--state-dir", state])
            check(rc == 0, f"store inspect failed: {err}")
            wal = re.search(r"wal: (\d+) segment\(s\), (\d+) bytes, (\d+) "
                            r"intact", text)
            snaps = re.search(r"snapshots: (\d+)", text)
            st = status2["store"]
            res["store_inspect"] = text.splitlines()
            check(wal is not None and snaps is not None
                  and int(wal.group(1)) == st["wal_segments"]
                  and int(wal.group(2)) == st["wal_bytes"]
                  and int(snaps.group(1)) == st["snapshots"],
                  f"store inspect {text!r} disagrees with /status {st}")
            proc.proc.send_signal(signal.SIGTERM)
            out, err = proc.finish(SERVE_TIMEOUT_S, "the daemon's drain")
            check(proc.proc.returncode == 0 and "service drained" in out,
                  f"the restarted daemon exited {proc.proc.returncode}: "
                  f"{err[-2000:]}")
            # the restarted daemon's own trace stream: its restore event
            # (snapshot load and WAL replay) and the obs verb's lint
            restored = [json.loads(ln) for ln in stream.read_text()
                        .splitlines() if '"service.restored"' in ln]
            check(len(restored) == 1, "no restore event in the stream")
            res["restart"]["replay_s"] = restored[0]["seconds"]
            rc, text, err = _cli(["obs", stream])
            res["restart"]["obs"] = text.splitlines()[0] if text else err
            check(rc == 0, f"obs rejected the daemon's stream: {err}")
        finally:
            proc.stop()
    res["wall_s"] = time.perf_counter() - t_phase
    emit("serve", **res)
    for k, v in launches.items():
        check(v > 0, f"{k} was not launched on the serve path")
    for k, v in follower_launches.items():
        check(v > 0, f"{k} was not launched on the follower's path")
    return launches, follower_launches


# --- the proof path ------------------------------------------------------------

def _rand_fr_u64(n: int, seed: int):
    """(n, 4) u64 standard rows of seeded random Fr values."""
    import numpy as np

    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 62, size=(n, 8), dtype=np.int64)
    w = (w[:, 0::2].astype("<u8") << np.uint64(2)) ^ w[:, 1::2].astype("<u8")
    w[:, 3] &= np.uint64((1 << 61) - 1)  # below 2^253 < p
    check(P > 1 << 253, "Fr is wider than 253 bits")
    return np.ascontiguousarray(w)


def _fs_to_natural(rows_u64, A: int, B: int):
    """FS-layout host rows (element k1 + k2·A at k1·B + k2) → natural."""
    return rows_u64.reshape(A, B, 4).transpose(1, 0, 2).reshape(-1, 4)


def _ntt_record(k: int, device) -> dict:
    """Forward, inverse and coset NTT at 2^k against the host core's
    ``FieldKernel`` and the plain stage product (float64 on the card),
    each form timed by graph replay; the bound is the stage products'
    int8 operations (or the planes' bytes, if larger)."""
    import numpy as np
    import torch

    from protocol_tpu_torch.native import prover as native
    from protocol_tpu_torch.ops import fieldops2 as f2
    from protocol_tpu_torch.ops import ntt_tpu
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
    from protocol_tpu_torch.zk.domain import EvaluationDomain
    from protocol_tpu_torch.zk.plonk import _find_coset_shifts

    n = 1 << k
    fk_host = native.FieldKernel(P)
    plan = ntt_tpu.NttPlan.get(k, device)
    A, B = plan.A, plan.B
    omega = EvaluationDomain(k).omega
    shift = _find_coset_shifts(4 * n, 2)[1]
    vals = _rand_fr_u64(n, 1000 + k)
    x = f2.upload_mont(vals, device)
    coset = f2.powers_vector(shift, n, device)
    forms = {
        "ntt": (lambda v, mm=ntt_tpu.stage_matmul: ntt_tpu.ntt(v, plan, mm),
                x),
        "intt": (lambda v, mm=ntt_tpu.stage_matmul:
                 ntt_tpu.intt(v, plan, mm), x),
        "coset_ntt": (lambda v, mm=ntt_tpu.stage_matmul: ntt_tpu.ntt(
            f2.mont_mul(v, coset), plan, mm), x),
    }
    host = {}
    h = vals.copy()
    fk_host.ntt(h, omega)
    host["ntt"] = h
    h = _fs_to_natural(vals, A, B).copy()  # intt takes FS layout input
    fk_host.ntt(h, omega, inverse=True)
    host["intt"] = h
    h = vals.copy()
    fk_host.coset_scale(h, shift)
    fk_host.ntt(h, omega)
    host["coset_ntt"] = h
    rec = {"n": n, "A": A, "B": B}
    ops = 2 * f2.L6 * f2.L6 * n * (A + B)  # 2 stages: 44·44 plane products
    planes_bytes = 2 * f2.L6 * n + f2.L6 * (A * A + B * B) + 2 * 88 * n
    bound_ms = max(planes_bytes / HBM_BYTES_PER_S,
                   ops / INT8_OPS_PER_S) * 1e3
    rec["bound_ms"] = bound_ms
    rec["bound_by"] = ("operations" if ops / INT8_OPS_PER_S
                       > planes_bytes / HBM_BYTES_PER_S else "bytes")
    for name, (fn, inp) in forms.items():
        ntt_tpu.reset_launches()
        got = fn(inp)
        launches = ntt_tpu.LAUNCHES["stage_matmul"]
        check(launches == 2 * f2.L6, f"{name} at 2^{k} ran {launches} "
              f"stage products, not {2 * f2.L6}")
        if name == "ntt" or name == "coset_ntt":
            got_host = _fs_to_natural(f2.download_std(got), A, B)
        else:
            got_host = f2.download_std(got)
        check(np.array_equal(got_host, host[name]),
              f"{name} at 2^{k} differs from the host core's")
        plain = fn(inp, ntt_tpu.stage_matmul_plain)
        check(torch.equal(plain, got),
              f"{name} at 2^{k} differs from its plain version")
        reps = 3 if k >= 20 else 10
        t = graph_ms(lambda i: fn(inp), reps)
        tp = graph_ms(lambda i: fn(inp, ntt_tpu.stage_matmul_plain),
                      2 if k >= 20 else 5, replays=3)
        rec[name] = {"ms": t["ms"], "plain_ms": tp["ms"]}
    # one stage product alone (the row of PERF.md's table): the forward
    # first stage's 44 _int_mm calls, and the same as float64
    x6 = f2.to_planes(x.reshape(A, B, f2.L)).permute(2, 1, 0).contiguous()
    lhs = x6.reshape(f2.L6 * B, A)
    st = graph_ms(lambda i: [ntt_tpu.stage_matmul(lhs, plan.W_A[m])
                             for m in range(f2.L6)], 3)
    stp = graph_ms(lambda i: [ntt_tpu.stage_matmul_plain(lhs, plan.W_A[m])
                              for m in range(f2.L6)], 2, replays=3)
    st_ops = 2 * f2.L6 * f2.L6 * n * A
    rec["stage_matmul"] = {
        "ms": st["ms"], "plain_ms": stp["ms"], "launches": f2.L6,
        "bound_ms": max(st_ops / INT8_OPS_PER_S,
                        (f2.L6 * n + f2.L6 * A * A + 4 * f2.L6 * f2.L6 * n)
                        / HBM_BYTES_PER_S) * 1e3}
    return rec


def _host_ext(fk_host, coeffs_u64, k: int, shift: int, blinds=None):
    """The host oracle of an ext chunk set: blinded coefficients
    zero-padded to 4n, coset-scaled, NTT'd (prove_fast's round 3)."""
    import numpy as np

    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
    from protocol_tpu_torch.zk.domain import EvaluationDomain

    n = 1 << k
    arr = np.zeros((4 * n, 4), dtype="<u8")
    arr[:n] = coeffs_u64
    for i, b in enumerate(blinds or ()):
        lo = int.from_bytes(arr[i].tobytes(), "little")
        hi = int.from_bytes(arr[n + i].tobytes(), "little")
        arr[i] = np.frombuffer(((lo - b) % P).to_bytes(32, "little"), "<u8")
        arr[n + i] = np.frombuffer(((hi + b) % P).to_bytes(32, "little"),
                                   "<u8")
    fk_host.coset_scale(arr, shift)
    fk_host.ntt(arr, EvaluationDomain(k + 2).omega)
    return arr


def _chunks_host_order(dp, chunks):
    """Device FS chunks → host ext order (element m = j + 4i)."""
    import numpy as np

    from protocol_tpu_torch.zk import prover_tpu as ptpu

    out = np.zeros((4 * dp.n, 4), dtype="<u8")
    for j, ch in enumerate(chunks):
        out[j::4] = ptpu.download_std(ptpu.natural_from_fs(ch, dp.A, dp.B))
    return out


def _dp_pieces(device, k: int) -> dict:
    """The DeviceProver at 2^k on seeded random fixed and σ columns, in
    resident, "fixed" and streaming residency: ext chunks (plain and
    blinded), the four quotient chunks (resident, streaming fused and
    chained, fixed), the 4n inverse and the ζ-evaluations, each equal
    to the host core's."""
    import numpy as np

    from protocol_tpu_torch.native import prover as native
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
    from protocol_tpu_torch.zk import prover_tpu as ptpu
    from protocol_tpu_torch.zk.domain import EvaluationDomain
    from protocol_tpu_torch.zk.plonk import _find_coset_shifts

    n = 1 << k
    ext_n = 4 * n
    shift = _find_coset_shifts(ext_n, 2)[1]
    fkh = native.FieldKernel(P)
    d, de = EvaluationDomain(k), EvaluationDomain(k + 2)
    fixed = [_rand_fr_u64(n, 100 + i) for i in range(9)]
    sigma = [_rand_fr_u64(n, 200 + i) for i in range(6)]
    t0 = time.perf_counter()
    dp = ptpu.DeviceProver(k, shift, fixed, sigma, device=device)
    init_s = time.perf_counter() - t0
    dp_stream = ptpu.DeviceProver(k, shift, fixed, sigma,
                                  ext_resident=False, device=device)
    dp_fixed = ptpu.DeviceProver(k, shift, fixed, sigma,
                                 ext_resident="fixed", device=device)
    rec = {"k": k, "resident_init_s": init_s}

    def host_ext(c, blinds=None):
        return _host_ext(fkh, c, k, shift, blinds)

    coeffs = _rand_fr_u64(n, 7)
    blinds = [12345, 999, 31337]
    dev_c = ptpu.upload_mont(coeffs, device)
    check(np.array_equal(_chunks_host_order(dp, dp.ext_chunks(dev_c)),
                         host_ext(coeffs)), "ext chunks differ from host")
    check(np.array_equal(
        _chunks_host_order(dp, dp.ext_chunks(dev_c, blinds)),
        host_ext(coeffs, blinds)), "blinded ext chunks differ from host")

    # the quotient on all four chunks against quotient_eval2
    wires = [_rand_fr_u64(n, 300 + w) for w in range(6)]
    z, m, phi = (_rand_fr_u64(n, s) for s in (400, 401, 402))
    pi_ev = _rand_fr_u64(n, 403)
    uv = [_rand_fr_u64(n, 404 + i) for i in range(4)]
    rng = np.random.default_rng(21)
    beta, gamma, beta_lk, alpha = [int(x) % P for x in
                                   rng.integers(1, 2 ** 62, 4)]
    shifts = _find_coset_shifts(n, 6)

    def coeffs_of(evals):
        c = evals.copy()
        fkh.ntt(c, d.omega, inverse=True)
        return c

    def omega_shift(c):
        c = c.copy()
        fkh.coset_scale(c, d.omega)
        return c

    pi_c = coeffs_of(pi_ev)
    xs = np.zeros((ext_n, 4), dtype="<u8")
    xs[:] = np.frombuffer(int(shift).to_bytes(32, "little"), "<u8")
    fkh.coset_scale(xs, de.omega)
    w4, shift_n = pow(de.omega, n, P), pow(shift, n, P)
    zh4 = [(shift_n * pow(w4, i, P) - 1) % P for i in range(4)]
    zh_inv = np.tile(native.ints_to_limbs([pow(v, -1, P) for v in zh4]),
                     (n, 1))
    zh_tiled = np.tile(native.ints_to_limbs(zh4), (n, 1))
    l0_den = fkh.scalar_mul(fkh.scalar_sub(xs, 1), n % P)
    fkh.batch_inverse(l0_den)
    t_host = fkh.quotient_eval(
        np.stack([host_ext(c) for c in wires]), host_ext(z),
        host_ext(omega_shift(z)), host_ext(m), host_ext(phi),
        host_ext(omega_shift(phi)), np.stack([host_ext(c) for c in uv]),
        np.stack([host_ext(coeffs_of(c)) for c in fixed]),
        np.stack([host_ext(coeffs_of(c)) for c in sigma]), host_ext(pi_c),
        xs, zh_inv, fkh.vec_mul(zh_tiled, l0_den), beta, gamma, beta_lk,
        alpha, shifts)

    def dev_ext(c):
        return dp.ext_chunks(ptpu.upload_mont(c, device))

    w_e = [dev_ext(c) for c in wires]
    z_e, m_e, phi_e, pi_e = (dev_ext(c) for c in (z, m, phi, pi_c))
    uv_e = [dev_ext(c) for c in uv]
    for name, prover, fused in (("resident", dp, True),
                                ("streaming_fused", dp_stream, True),
                                ("streaming_chain", dp_stream, False),
                                ("fixed", dp_fixed, False)):
        prover.fused_quotient = fused
        ch = prover.challenge_planes(beta, gamma, beta_lk, alpha, shifts)
        t_dev = [prover.quotient_chunk(j, [w[j] for w in w_e], z_e[j],
                                       m_e[j], phi_e[j], pi_e[j],
                                       [u[j] for u in uv_e], ch)
                 for j in range(4)]
        check(np.array_equal(_chunks_host_order(prover, t_dev), t_host),
              f"{name} quotient differs from the host's quotient_eval2")
        rec[f"quotient_{name}"] = True

    # the 4n inverse
    ext_vals = _rand_fr_u64(ext_n, 11)
    chunks = [ptpu.fs_from_natural(ptpu.upload_mont(
        np.ascontiguousarray(ext_vals[j::4]), device), dp.A, dp.B)
        for j in range(4)]
    got = np.concatenate([ptpu.download_std(c) for c in dp.intt_ext(chunks)])
    host = ext_vals.copy()
    fkh.ntt(host, de.omega, inverse=True)
    fkh.coset_scale(host, shift, invert=True)
    check(np.array_equal(got, host), "intt_ext differs from the host")

    # ζ-evaluations: barycentric from evals and ζ-power dots from coeffs
    evals = _rand_fr_u64(n, 13)
    zeta = 0x1234567890ABCDEF1234567
    expect = fkh.poly_eval_many(coeffs_of(evals).reshape(1, n, 4), zeta)[0]
    ev = ptpu.upload_mont(evals, device)
    check(dp.eval_at(ev, zeta) == int(expect), "barycentric eval differs")
    check(dp.eval_coeffs_at_many([dp.intt_natural(ev)], zeta)
          == [int(expect)], "coefficient eval differs")
    return rec


@contextlib.contextmanager
def _msm_device_flag(on: bool):
    """``PTPU_MSM_DEVICE=1`` (commits through the device MSM) set, or
    unset, for the calls inside; the old value after."""
    old = os.environ.get("PTPU_MSM_DEVICE")
    if on:
        os.environ["PTPU_MSM_DEVICE"] = "1"
    else:
        os.environ.pop("PTPU_MSM_DEVICE", None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PTPU_MSM_DEVICE", None)
        else:
            os.environ["PTPU_MSM_DEVICE"] = old


def _commit_stage_s(path: str) -> dict:
    return {k: v for k, v in _stage_seconds(path).items()
            if k.startswith("commit.")}


def _lockstep(device, k: int, msm_device: bool = False) -> dict:
    """A synthetic circuit proved by ``prove_fast_tpu`` on the card and
    ``prove_fast`` on the host from one seeded blinding stream: the
    proofs must be the same bytes, and verify. With ``msm_device`` the
    card's prove runs under ``PTPU_MSM_DEVICE=1``, so its commits go
    through the device MSM too; the host prove commits on the host."""
    import random

    from protocol_tpu_torch.cli.profilecmd import synthetic_circuit
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as R
    from protocol_tpu_torch.zk import prover_fast as pf
    from protocol_tpu_torch.zk.plonk import verify

    cs = synthetic_circuit(gates=(1 << k) - 64, seed=k, lookup_row=True)
    params = pf.setup_params_fast(k, seed=b"chip-smoke-lockstep")
    pk = pf.keygen_fast(params, cs, k=k, eval_pk=True)
    r1, r2 = random.Random(42), random.Random(42)
    dev_commits0 = _commit_stage_s("device")
    t0 = time.perf_counter()
    with _msm_device_flag(msm_device):
        dev = pf.prove_fast_tpu(params, pk, cs,
                                randint=lambda: r1.randrange(R),
                                device=device)
    dev_s = time.perf_counter() - t0
    host_commits0 = _commit_stage_s("host")
    t0 = time.perf_counter()
    with _msm_device_flag(False):
        host = pf.prove_fast(params, pk, cs, randint=lambda: r2.randrange(R))
    host_s = time.perf_counter() - t0
    check(dev == host, f"k={k}: the card's proof differs from the host's")
    check(verify(params, pk, cs.public_values(), dev),
          f"k={k}: the card's proof does not verify")
    pf._DEVICE_PROVERS.clear()

    def spent(now, before):
        return sum(v - before.get(key, 0.0) for key, v in now.items())

    return {"k": k, "rows": cs.num_rows, "msm_device": msm_device,
            "device_prove_s": dev_s, "host_prove_s": host_s,
            "device_prove_commits_s": spent(_commit_stage_s("device"),
                                            dev_commits0),
            "host_prove_commits_s": spent(_commit_stage_s("host"),
                                          host_commits0),
            "bytes": len(dev)}


def _stage_seconds(path: str) -> dict:
    from protocol_tpu_torch.utils import trace

    out: dict = {}
    for items, s in trace.histogram("prover_stage_seconds").series():
        labels = dict(items)
        if labels.get("path") == path:
            out[labels["stage"]] = out.get(labels["stage"], 0.0) + s["sum"]
    return out


# the device prove's round-3/4 stages (sync-span mode attributes the
# device time to them); the ext-chunk NTTs of round 3 are launched early,
# inside the round-1/2 stages, and commit.* are the host's MSMs
DEVICE_R34_STAGES = ("quotient_chunks", "intt_ext", "evals", "openings")


def _et_cli(device, rec: dict) -> dict:
    """The proof verbs at the tiny shape on the card: the k = 20 SRS (the
    api's, seeded, where ``kzg-params`` writes it; the verb itself once
    at k = 10), ``et-proving-key``, two mnemonics attesting each other,
    ``et-proof`` with rounds 3–4 on the card, ``et-verify`` VALID, and
    INVALID on a flipped byte."""
    import torch

    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic
    from protocol_tpu_torch.ops import ntt_tpu
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils import trace
    from protocol_tpu_torch.zk import api as zk
    from protocol_tpu_torch.zk import prover_fast as pf

    keys = [ecdsa_keypairs_from_mnemonic(m, 1)[0] for m in PROVE_MNEMONICS]
    addrs = ["0x" + kp.public_key.to_address_bytes().hex() for kp in keys]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        files = EigenFile(Path(d))
        rc, out, err = _cli(["--assets", d, "kzg-params", "--k", 10])
        check(rc == 0 and files.kzg_params(10).exists(),
              f"kzg-params --k 10: rc {rc} {err[-300:]}")
        t0 = time.perf_counter()
        files.kzg_params(20).write_bytes(
            zk.generate_kzg_params(20, seed=PROVE_SRS_SEED))
        rec["srs_k20_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc, out, err = _cli(["--assets", d, "et-proving-key", "--shape",
                             "tiny"])
        rec["keygen_s"] = time.perf_counter() - t0
        check(rc == 0, f"et-proving-key: rc {rc} {err[-300:]}")
        rc = _cli(["--assets", d, "deploy"])[0]
        check(rc == 0, "deploy failed")
        for i, m in enumerate(PROVE_MNEMONICS):
            rc, _, err = _cli(["--assets", d, "attest", "--to",
                               addrs[1 - i], "--score", 40 + 30 * i],
                              env={"MNEMONIC": m})
            check(rc == 0, f"attest {i}: {err[-300:]}")
        check(_cli(["--assets", d, "attestations"])[0] == 0,
              "attestations failed")

        trace.TRACER.reset_instruments()
        trace.sync_spans(True)  # stage times carry their device work
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launches()
        ntt_tpu.reset_launches()
        t0 = time.perf_counter()
        rc, out, err = _cli(["--assets", d, "et-proof", "--shape", "tiny"],
                            env={"MNEMONIC": PROVE_MNEMONICS[0]})
        rec["prove_s"] = time.perf_counter() - t0
        trace.sync_spans(False)
        check(rc == 0, f"et-proof: rc {rc} {err[-500:]}")
        rec["launches"] = dict(fk.LAUNCHES)
        rec["stage_matmul_launches"] = ntt_tpu.LAUNCHES["stage_matmul"]
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        stages = _stage_seconds("device")
        rec["stages_s"] = stages
        rec["host_commits_s"] = sum(v for k, v in stages.items()
                                    if k.startswith("commit."))
        rec["device_r34_s"] = sum(stages.get(k, 0.0)
                                  for k in DEVICE_R34_STAGES)
        check(stages.get("quotient_chunks", 0) > 0
              and stages.get("intt_ext", 0) > 0,
              f"the prove ran no device stage: {sorted(stages)}")
        check(rec["launches"]["mont_mul"] > 0
              and rec["launches"]["add_mod"] > 0
              and rec["launches"]["sub_mod"] > 0
              and rec["stage_matmul_launches"] > 0,
              f"the prove launched {rec['launches']}")
        pf._DEVICE_PROVERS.clear()

        t0 = time.perf_counter()
        rc, out, err = _cli(["--assets", d, "et-verify", "--shape", "tiny"])
        rec["verify_s"] = time.perf_counter() - t0
        check(rc == 0 and "VALID" in out and "INVALID" not in out,
              f"et-verify: rc {rc} {out[-200:]} {err[-300:]}")
        rec["evm"] = _et_verifier(d)
        proof = bytearray(files.et_proof().read_bytes())
        proof[len(proof) // 2] ^= 1
        files.et_proof().write_bytes(bytes(proof))
        rc, out, err = _cli(["--assets", d, "et-verify", "--shape", "tiny"])
        check(rc == 1 and "INVALID" in out,
              f"et-verify on a flipped byte: rc {rc} {out[-200:]}")
        rc, out, err = _cli(["--assets", d, "et-verifier", "--shape", "tiny",
                             "--check"])
        check(rc == 1 and "EVM replay: INVALID" in out,
              f"et-verifier --check on a flipped byte: rc {rc} "
              f"{out[-200:]} {err[-300:]}")
        rec["proof_bytes"] = len(proof)
    return rec


def _et_verifier(d: str) -> dict:
    """The EVM verifier of the card's proof: ``et-verifier --check``
    (its transcript from ``et-proof.meta.json``) must replay VALID in
    the in-repo Yul EVM, and ``--rpc`` must deploy it to an in-process
    ``MockNode`` and verify VALID on-chain. Returns the gas and walls."""
    from protocol_tpu_torch.client.mocknode import MockNode

    rec: dict = {}
    t0 = time.perf_counter()
    rc, out, err = _cli(["--assets", d, "et-verifier", "--shape", "tiny",
                         "--check"])
    rec["check_s"] = time.perf_counter() - t0
    check(rc == 0 and "EVM replay: VALID" in out,
          f"et-verifier --check: rc {rc} {out[-300:]} {err[-300:]}")
    m = re.search(r"EVM replay: VALID \((\d+) gas, (\w+) transcript", out)
    check(m is not None, f"et-verifier --check printed {out[-300:]}")
    rec["replay_gas"], rec["transcript"] = int(m.group(1)), m.group(2)
    node = MockNode()
    url = node.start()
    try:
        t0 = time.perf_counter()
        rc, out, err = _cli(["--assets", d, "et-verifier", "--shape", "tiny",
                             "--rpc", url],
                            env={"MNEMONIC": PROVE_MNEMONICS[0]})
        rec["rpc_s"] = time.perf_counter() - t0
    finally:
        node.stop()
    m = re.search(r"on-chain verify at 0x[0-9a-f]+: VALID \((\d+) gas", out)
    check(rc == 0 and m is not None,
          f"et-verifier --rpc: rc {rc} {out[-300:]} {err[-300:]}")
    rec["onchain_gas"] = int(m.group(1))
    return rec


def phase_prove_pieces(device) -> dict:
    """The device prover's pieces (``zk/prover_tpu.py``, the NTT's stage
    products on ``_int_mm``, every field product on B2 and every sum on
    ``add_mod``/``sub_mod``), held against the host prover core and
    timed: the NTT at three sizes, a k = 16 ``DeviceProver`` and a
    k = 14 lockstep prove. Returns the NTT records."""
    import torch

    from protocol_tpu_torch.native import prover as native

    check(native.available(), "the prover core did not build")
    t_phase = time.perf_counter()
    ntt = {}
    for k in PROVE_NTT_KS:
        ntt[k] = _ntt_record(k, device)
        emit("prove_ntt", **ntt[k])
    torch.cuda.empty_cache()
    dp = _dp_pieces(device, PROVE_DP_K)
    emit("prove_device_prover", **dp)
    torch.cuda.empty_cache()
    lock = _lockstep(device, PROVE_LOCKSTEP_K)
    emit("prove_lockstep", **lock)
    torch.cuda.empty_cache()
    return {"ntt": ntt, "wall_s": time.perf_counter() - t_phase}


def phase_prove(device, pieces: dict) -> dict:
    """The EigenTrust proof verbs at the tiny shape on the card (rounds
    3–4 of ``prove_fast_tpu``) and the profile verb's stage coverage;
    returns the field kernels' launches of the k = 20 prove."""
    import torch

    t_phase = time.perf_counter()
    ntt = pieces["ntt"]
    rec = _et_cli(device, {})
    emit("prove_et", **rec)
    torch.cuda.empty_cache()

    # stage attribution: the profile verb's coverage check, k = 18, on
    # its own instruments (the verb reads every prover series)
    from protocol_tpu_torch.utils import trace

    trace.TRACER.reset_instruments()
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        report = Path(d) / "profile.json"
        t0 = time.perf_counter()
        rc, out, err = _cli(["profile", "--workload", "prove", "--k",
                             PROVE_PROFILE_K, "--gates",
                             (1 << PROVE_PROFILE_K) - 64, "--json", report,
                             "--min-coverage", PROVE_MIN_COVERAGE])
        prof_s = time.perf_counter() - t0
        check(rc == 0, f"profile --workload prove: rc {rc} {err[-400:]}")
        rep = json.loads(report.read_text())
    emit("prove_profile", k=PROVE_PROFILE_K, wall_s=prof_s,
         coverage=rep["coverage"], prove_total_s=rep["prove_total_s"],
         stages={k: v["total_s"] for k, v in rep["stages"].items()})
    from protocol_tpu_torch.zk import prover_fast as pf

    pf._DEVICE_PROVERS.clear()
    torch.cuda.empty_cache()
    trace.sync_spans(False)  # the verb turned it on
    emit("prove", wall_s=time.perf_counter() - t_phase,
         pieces_wall_s=pieces["wall_s"],
         ntt_ms={k: v["ntt"]["ms"] for k, v in ntt.items()},
         prove_s=rec["prove_s"], host_commits_s=rec["host_commits_s"],
         device_r34_s=rec["device_r34_s"], launches=rec["launches"])
    return {"launches": rec["launches"], "ntt": ntt}


def _proves_by_path() -> dict:
    """{path: proves} from the prover's whole-prove histogram."""
    from protocol_tpu_torch.utils import trace

    out: dict = {}
    for items, s in trace.histogram("prover_total_seconds").series():
        labels = dict(items)
        key = f"{labels.get('path')}/k{labels.get('k')}"
        out[key] = out.get(key, 0) + s["count"]
    return out


def _th_spans() -> dict:
    from protocol_tpu_torch.utils import trace

    return {k: v["total_s"] for k, v in trace.summary().items()
            if k.startswith("th.")}


def phase_threshold(device) -> dict:
    """The Threshold flow through the CLI's verbs at its only shape (4
    peers, 20 iterations, k = 21): a seeded k = 21 SRS where
    ``kzg-params`` writes it, ``deploy``, 12 ``attest``s by the four
    mnemonics, ``attestations``, ``th-proving-key`` (keygen and prove a
    dummy inner EigenTrust snark, then keygen the Threshold circuit
    that aggregates it), ``th-proof`` in the same process (the inner
    snark and the Threshold circuit, both proved with rounds 3–4 on the
    card), its ``threshold_check`` equal to ``Client.verify_threshold``
    on the host, ``th-verify`` VALID (the PLONK verify plus the deferred
    KZG decide on the 16 accumulator limbs) and INVALID on a flipped
    byte. Returns the field kernels' launches of th-proving-key and
    th-proof together."""
    import torch

    from protocol_tpu_torch.cli.fs import EigenFile
    from protocol_tpu_torch.cli.main import (
        TH_PARAMS_K,
        _load_attestations,
        _load_config,
    )
    from protocol_tpu_torch.client import Client
    from protocol_tpu_torch.client.circuit_io import ThPublicInputs
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic
    from protocol_tpu_torch.ops import ntt_tpu
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils import trace
    from protocol_tpu_torch.zk import api as zk
    from protocol_tpu_torch.zk import prover_fast as pf

    t_phase = time.perf_counter()
    rec: dict = {"k": TH_PARAMS_K}
    keys = [ecdsa_keypairs_from_mnemonic(m, 1)[0] for m in SCORES_MNEMONICS]
    addrs = ["0x" + kp.public_key.to_address_bytes().hex() for kp in keys]
    saved = os.environ.get("PTPU_TH_CACHE_DIR")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        files = EigenFile(Path(d))
        # the dummy inner snark holds a k = 21 key: keep it in the
        # temporary assets, gone with them
        os.environ["PTPU_TH_CACHE_DIR"] = str(Path(d) / "th-cache")
        try:
            t0 = time.perf_counter()
            files.kzg_params(TH_PARAMS_K).write_bytes(
                zk.generate_kzg_params(TH_PARAMS_K, seed=TH_SRS_SEED))
            rec["srs_s"] = time.perf_counter() - t0
            check(_cli(["--assets", d, "deploy"])[0] == 0, "deploy failed")
            for i, m in enumerate(SCORES_MNEMONICS):
                for j, about in enumerate(addrs):
                    if i != j:
                        rc, _, err = _cli(["--assets", d, "attest", "--to",
                                           about, "--score",
                                           10 + 20 * i + 3 * j],
                                          env={"MNEMONIC": m})
                        check(rc == 0, f"attest {i}->{j}: {err[-300:]}")
            check(_cli(["--assets", d, "attestations"])[0] == 0,
                  "attestations failed")

            trace.TRACER.reset()
            trace.TRACER.reset_instruments()
            trace.sync_spans(True)  # stage times carry their device work
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fk.reset_launches()
            ntt_tpu.reset_launches()
            t0 = time.perf_counter()
            rc, out, err = _cli(["--assets", d, "th-proving-key"])
            rec["th_pk_s"] = time.perf_counter() - t0
            check(rc == 0 and files.th_proving_key().exists(),
                  f"th-proving-key: rc {rc} {err[-800:]}")
            rec["th_pk_peak_device_bytes"] = torch.cuda.max_memory_allocated()
            rec["th_pk_launches"] = dict(fk.LAUNCHES)
            rec["th_pk_proves"] = _proves_by_path()
            rec["th_pk_spans_s"] = _th_spans()
            check(rec["th_pk_proves"] == {"device/k21": 1},
                  f"th-proving-key proved {rec['th_pk_proves']}")

            trace.TRACER.reset()
            trace.TRACER.reset_instruments()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            rc, out, err = _cli(["--assets", d, "th-proof", "--peer",
                                 addrs[TH_PEER], "--threshold",
                                 TH_THRESHOLD])
            rec["th_proof_s"] = time.perf_counter() - t0
            trace.sync_spans(False)
            check(rc == 0, f"th-proof: rc {rc} {err[-800:]}")
            rec["th_proof_peak_device_bytes"] = \
                torch.cuda.max_memory_allocated()
            rec["launches"] = dict(fk.LAUNCHES)
            rec["th_proof_launches"] = {
                k: v - rec["th_pk_launches"].get(k, 0)
                for k, v in rec["launches"].items()}
            rec["stage_matmul_launches"] = ntt_tpu.LAUNCHES["stage_matmul"]
            rec["th_proof_proves"] = _proves_by_path()
            rec["th_proof_spans_s"] = _th_spans()
            stages = _stage_seconds("device")
            rec["th_proof_stages_s"] = stages
            rec["th_proof_host_commits_s"] = sum(
                v for k, v in stages.items() if k.startswith("commit."))
            rec["th_proof_device_r34_s"] = sum(
                stages.get(k, 0.0) for k in DEVICE_R34_STAGES)
            # both proves (inner EigenTrust snark, outer Threshold
            # circuit) on the card, none on the host
            check(rec["th_proof_proves"] == {"device/k21": 2},
                  f"th-proof proved {rec['th_proof_proves']}")
            check(all(rec["th_proof_launches"].get(k, 0) > 0
                      for k in ("mont_mul", "add_mod", "sub_mod"))
                  and rec["stage_matmul_launches"] > 0,
                  f"th-proof launched {rec['th_proof_launches']}")

            pubs = ThPublicInputs.from_bytes(
                files.th_public_inputs().read_bytes())
            client = Client(_load_config(files), SCORES_MNEMONICS[0],
                            batched_ingest=False)
            host_check = client.verify_threshold(
                _load_attestations(files),
                bytes.fromhex(addrs[TH_PEER][2:]), TH_THRESHOLD)
            rec["threshold_check"] = bool(pubs.threshold_check)
            check(bool(host_check)
                  and rec["threshold_check"] == bool(host_check),
                  f"threshold_check {pubs.threshold_check} against the "
                  f"host's {host_check}")
            check(len(pubs.agg_instances) == 16,
                  f"{len(pubs.agg_instances)} accumulator limbs")

            t0 = time.perf_counter()
            rc, out, err = _cli(["--assets", d, "th-verify"])
            rec["th_verify_s"] = time.perf_counter() - t0
            check(rc == 0 and "Threshold proof: VALID" in out,
                  f"th-verify: rc {rc} {out[-200:]} {err[-300:]}")
            proof = bytearray(files.th_proof().read_bytes())
            proof[len(proof) // 2] ^= 1
            files.th_proof().write_bytes(bytes(proof))
            rc, out, err = _cli(["--assets", d, "th-verify"])
            check(rc == 1 and "Threshold proof: INVALID" in out,
                  f"th-verify on a flipped byte: rc {rc} {out[-200:]}")
            rec["proof_bytes"] = len(proof)
        finally:
            trace.sync_spans(False)
            if saved is None:
                os.environ.pop("PTPU_TH_CACHE_DIR", None)
            else:
                os.environ["PTPU_TH_CACHE_DIR"] = saved
            pf._DEVICE_PROVERS.clear()
            zk._INNER_ET_PK_CACHE.clear()
            del zk._PK_PARSE_CACHE[:]
            torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t_phase
    return rec


def _lease_first_units(store) -> None:
    """Publish the first unit of each dispatch only once the
    prove-worker holds its lease (or has put its result), as
    ``tests/test_torch_fabric.py`` does for every unit. The pool's own
    threads claim a job's units in the order the worker lists them, so
    left alone the worker mostly runs units the pool already took; a
    live lease makes the rendezvous wait for the worker's result and
    apply it. An idle pool worker lending a hand still runs a unit
    whatever its lease, so the phase's later jobs keep it busy."""
    publish = store.publish

    def publish_leased(job_id, unit):
        fid = publish(job_id, unit)
        if unit.index == 0:
            t_end = time.monotonic() + 30.0
            while store.lease_state(fid) == "none" and not os.path.exists(
                    store._path("results", fid + ".bin")) \
                    and time.monotonic() < t_end:
                time.sleep(0.005)
        return fid

    store.publish = publish_leased


def phase_fabric(device) -> dict:
    """The proving fabric on the card: a ``TrustService`` with a state
    dir, two pool workers, ``shard_proves=1`` and ``fabric=1`` serves a
    ``synthetic`` job kind that proves a FABRIC_K synthetic circuit
    (``cli/profilecmd.synthetic_circuit``) on the card through
    ``prove_fast_tpu`` (the device path ``prove_auto`` routes a CUDA
    device to; it takes the seeded blinding stream ``prove_auto`` does
    not), while ``python -m protocol_tpu_torch.cli prove-worker``
    polls ``<state-dir>/fabric`` as its own process. Jobs go through
    ``POST /proofs`` one at a time, up to FABRIC_MAX_JOBS, until one has
    ``prove.shard`` spans with ``remote=1`` under the worker's name.
    Held: the worker registers, every job's proof equals the unsharded
    prove's bytes (and verifies), the fabric series are on
    ``/metrics``, ``fleet`` lists the prove-worker, the worker exits 0
    on SIGTERM."""
    import random
    import signal
    import threading

    import torch

    from protocol_tpu_torch.cli.profilecmd import synthetic_circuit
    from protocol_tpu_torch.client import Client, ClientConfig
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.service import ServiceConfig, TrustService
    from protocol_tpu_torch.utils import trace
    from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as R
    from protocol_tpu_torch.zk import prover_fast as pf
    from protocol_tpu_torch.zk.plonk import verify

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    rec: dict = {"k": FABRIC_K}
    t0 = time.perf_counter()
    cs = synthetic_circuit(gates=(1 << FABRIC_K) - 64, seed=FABRIC_SEED,
                           lookup_row=True)
    params = pf.setup_params_fast(FABRIC_K, seed=b"chip-smoke-fabric")
    pk = pf.keygen_fast(params, cs, k=FABRIC_K, eval_pk=True)
    rec["setup_s"] = time.perf_counter() - t0

    def prove() -> bytes:
        rng = random.Random(FABRIC_SEED)
        return pf.prove_fast_tpu(params, pk, cs,
                                 randint=lambda: rng.randrange(R),
                                 device=device)

    def post(kind: str) -> str:
        status, _, body = _http_raw(
            url, "/proofs", data=json.dumps({"kind": kind}).encode(),
            headers={"Content-Type": "application/json"})
        check(status == 202, f"POST /proofs {kind} answered {status}")
        return json.loads(body)["job_id"]

    def finished(job_id: str) -> dict:
        _wait_for(lambda: _http(url, f"/proofs/{job_id}")["status"]
                  in ("done", "failed"), f"job {job_id}",
                  timeout=FABRIC_JOB_TIMEOUT_S)
        job = _http(url, f"/proofs/{job_id}")
        check(job["status"] == "done", f"job {job_id}: {job.get('error')}")
        return job

    # a "hold" job keeps the second pool worker busy until the gate opens
    gate = threading.Event()
    proc = svc = None
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as d:
        state = Path(d) / "service-state"
        # the worker process starts first: its start-up (a Python
        # process importing torch) runs under the unsharded prove
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   PTPU_SERVE_TELEMETRY_INTERVAL="0.5")
        t_worker = time.perf_counter()
        proc = _Child(
            [sys.executable, "-m", "protocol_tpu_torch.cli", "--assets", d,
             "prove-worker", "--state-dir", state, "--name",
             FABRIC_WORKER, "--poll", "0.02"], d, "prove-worker", env)
        try:
            t0 = time.perf_counter()
            proof = prove()  # cold: the device prover's init included
            rec["unsharded_prove_s"] = time.perf_counter() - t0
            check(verify(params, pk, cs.public_values(), proof),
                  "the unsharded proof does not verify")
            pf._DEVICE_PROVERS.clear()
            svc = TrustService(
                Client(ClientConfig(), SCORES_MNEMONICS[0],
                       device=None if on_card else device),
                ServiceConfig(port=0, poll_interval=0.05,
                              refresh_interval=0.05, pool_workers=2,
                              shard_proves=1, fabric=1),
                str(state / "cursor"),
                provers={"synthetic": lambda p: {"proof": prove().hex()},
                         "hold": lambda p: {"released": gate.wait(
                             FABRIC_JOB_TIMEOUT_S)}},
                state_dir=str(state))
            check(svc.fabric is not None and svc.jobs.fabric is svc.fabric
                  and "synthetic" in svc.jobs.shard_kinds,
                  "the daemon built no fabric")
            _lease_first_units(svc.fabric)
            url = svc.start()
            line = proc.first_line(SERVE_TIMEOUT_S)
            check(f"prove-worker {FABRIC_WORKER} polling" in line,
                  f"the prove-worker did not start: {line!r}")
            _wait_for(lambda: (_http(url, "/status")["pool"]["fabric"]
                               or {}).get("workers_live", 0) >= 1,
                      "the prove-worker's registration", timeout=120.0)
            rec["worker_up_s"] = time.perf_counter() - t_worker
            if on_card:
                torch.cuda.synchronize()
            fk.reset_launches()
            jobs = []
            for n in range(FABRIC_MAX_JOBS):
                # the first job free, so the idle pool worker lends; the
                # next beside a held one: with no idle lender the first
                # unit, leased by the worker, waits for the worker's
                # result (an idle lender runs units whatever their lease)
                hold = None
                if n > 0:
                    hold = post("hold")
                    _wait_for(lambda: _http(url, f"/proofs/{hold}")[
                        "status"] == "running", f"job {hold} running",
                        timeout=FABRIC_JOB_TIMEOUT_S)
                n0 = len(trace.TRACER.spans)
                job_id = post("synthetic")
                try:
                    job = finished(job_id)
                finally:
                    gate.set()
                if hold is not None:
                    finished(hold)
                gate.clear()
                check(bytes.fromhex(job["result"]["proof"]) == proof,
                      f"job {job_id}: the sharded proof differs from the "
                      "unsharded prove's bytes")
                shards = [s for s in list(trace.TRACER.spans)[n0:]
                          if s.name == "prove.shard"
                          and job_id in s.trace_ids]
                by_stage: dict = {}
                for s in shards:
                    by_stage[s.fields["stage"]] = by_stage.get(
                        s.fields["stage"], 0) + 1
                remote = [s for s in shards if s.fields.get("remote") == 1]
                check(all(s.fields.get("worker") == FABRIC_WORKER
                          for s in remote),
                      "a remote unit carries another worker's name")
                jobs.append({"job_id": job_id, "worker": job.get("worker"),
                             "beside_held_job": hold is not None,
                             "prove_s": job["finished_at"]
                             - job["started_at"],
                             "units": by_stage, "remote_units": len(remote),
                             "lent_units": sum(
                                 1 for s in shards if not s.fields.get(
                                     "remote") and s.fields.get("worker")
                                 != job.get("worker"))})
                if remote:
                    break
            if on_card:
                torch.cuda.synchronize()
            rec["launches"] = {k: fk.LAUNCHES[k]
                               for k in ("mont_mul", "add_mod", "sub_mod")}
            rec["jobs"] = jobs
            rec["jobs_tried"] = len(jobs)
            rec["remote_units"] = sum(j["remote_units"] for j in jobs)
            check(rec["remote_units"] >= 1, f"no unit was executed by "
                  f"{FABRIC_WORKER} in {len(jobs)} jobs")
            metrics = _http(url, "/metrics")
            rec["fabric_units_total"] = _series(metrics,
                                                "ptpu_fabric_units_total")
            missing = [n for n in ("ptpu_fabric_units_total",
                                   "ptpu_fabric_workers",
                                   "ptpu_fabric_lease_age_seconds",
                                   "ptpu_prove_shards_total")
                       if n not in metrics]
            check(not missing, f"/metrics misses {missing}")
            rec["status_fabric"] = _http(url, "/status")["pool"]["fabric"]
            _wait_for(lambda: "prove-worker" in {
                r["role"] for r in _http(url, "/fleet")["instances"]},
                "the prove-worker's row on /fleet", timeout=60.0)
            rc, text, err = _cli(["fleet", "--url", url])
            check(rc == 0 and FABRIC_WORKER in text
                  and "prove-worker" in text,
                  f"fleet does not list the prove-worker: {text!r} {err}")
            proc.proc.send_signal(signal.SIGTERM)
            out, err = proc.finish(120.0, "the prove-worker's exit")
            rec["worker_exit"] = out.strip().splitlines()[-1:]
            check(proc.proc.returncode == 0, f"the prove-worker exited "
                  f"{proc.proc.returncode}: {err[-2000:]}")
        finally:
            gate.set()
            if svc is not None:
                svc.shutdown()
            proc.stop()
    for k, v in rec["launches"].items():
        check(v > 0, f"{k} was not launched on the fabric path")
    rec["wall_s"] = time.perf_counter() - t_phase
    emit("fabric", **rec)
    return rec


def _msm_srs(n: int) -> tuple:
    """A seeded SRS of ``n`` G1 powers of τ on the host's fixed-base
    kernel, and seeded scalars below R: (bases as (n, 8) limbs for the
    host MSM, the same as affine int pairs for the device MSM, scalars
    as (n, 4) limbs, the same as ints)."""
    import numpy as np

    from protocol_tpu_torch.native import prover as native
    from protocol_tpu_torch.utils.fields import (
        BN254_FQ_MODULUS as Q,
        BN254_FR_MODULUS as R,
    )
    from protocol_tpu_torch.zk.bn254 import G1_GEN

    tau = int.from_bytes(MSM_SRS_SEED, "little") % (R - 1) + 1
    powers = [1] * n
    for i in range(1, n):
        powers[i] = powers[i - 1] * tau % R
    limbs = native.g1_fixed_base_muls(Q, G1_GEN, native.ints_to_limbs(powers))
    vals = native.limbs_to_ints(limbs.reshape(-1, 4))
    rng = random.Random(MSM_SCALAR_SEED)
    raw = np.frombuffer(rng.getrandbits(256 * n).to_bytes(32 * n, "little"),
                        dtype="<u8").reshape(n, 4).copy()
    raw[:, 3] &= (1 << 61) - 1  # below 2^253 < R
    return (limbs, list(zip(vals[0::2], vals[1::2])), raw,
            native.limbs_to_ints(raw))


def _msm_add_times(device, xs, ys) -> dict:
    """One group-law add (``secp_batch._add``, the MSM's step) at the
    scan's lane counts and at the telescope's one lane: device ms by
    CUDA-graph replay, and at one lane the host's pace (ms a call, run
    back to back and synchronised), which sets the telescope's time."""
    import torch

    from protocol_tpu_torch.ops import msm_device as md

    out = {}
    for lanes, launches in MSM_ADD_LANES:
        one = md.mont_one(md.CTX_Q, lanes, device).contiguous()
        p = (xs[:lanes], ys[:lanes], one)
        q = (ys[:lanes], xs[:lanes], one)
        rec = graph_ms(lambda i, p=p, q=q: md._add(md.CTX_Q, p, q),
                       launches)
        if lanes == 1:
            for _ in range(3):
                md._add(md.CTX_Q, p, q)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(launches):
                md._add(md.CTX_Q, p, q)
            torch.cuda.synchronize()
            rec["host_ms"] = (time.perf_counter() - t0) * 1e3 / launches
        out[lanes] = rec
        torch.cuda.empty_cache()
    return out


def phase_msm(device) -> dict:
    """The device MSM (``ops/msm_device.py``, every field op on B2,
    ``add_mod`` and ``sub_mod``) at full width (c = 4, 66 windows) over
    2^16 and 2^20 bases of a seeded SRS with seeded scalars below R:
    each result equal to the host's ``g1_msm_multi`` on the same bases
    and scalars, its field launches equal to ``launch_counts``, P and −P
    cancelling to the identity. Timed: host prep (ints to limbs, upload),
    device s (synchronised), the host MSM beside it, the MSM's peak
    device memory above what the process held, and one group-law add.
    Returns the phase's record, its field launches under
    ``launches``."""
    import torch

    from protocol_tpu_torch.native import prover as native
    from protocol_tpu_torch.ops import msm_device as md
    from protocol_tpu_torch.ops.kernels import field_kernel as fk
    from protocol_tpu_torch.utils.fields import BN254_FQ_MODULUS as Q

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    limbs, points, raw, scalars = _msm_srs(max(MSM_SIZES))
    srs_s = time.perf_counter() - t0
    total = dict.fromkeys(fk.LAUNCHES, 0)
    runs = {}
    for n in MSM_SIZES:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fk.reset_launches()
        t0 = time.perf_counter()
        got = md.msm_device(points[:n], scalars[:n], c=MSM_C, device=device)
        wall_s = time.perf_counter() - t0
        launches = dict(fk.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - held  # the MSM's own
        t0 = time.perf_counter()
        host = native.g1_msm_multi(Q, limbs[:n], raw[None, :n])[0]
        host_s = time.perf_counter() - t0
        check(got is not None and got == host,
              f"msm n={n}: the device MSM differs from g1_msm_multi")
        expect = md.launch_counts(n, MSM_C)
        check(launches == expect, f"msm n={n}: launches {launches}, the "
              f"code's count {expect}")
        for k in total:
            total[k] += launches[k]
        runs[n] = {"n": n, "host_prep_s": md.SECONDS["prep"],
                   "device_s": md.SECONDS["device"], "wall_s": wall_s,
                   "host_msm_s": host_s, "launches": launches,
                   "peak_device_bytes": peak}
        emit("msm_run", **runs[n])
        torch.cuda.empty_cache()

    fk.reset_launches()
    p = points[1]
    t0 = time.perf_counter()
    cancel = md.msm_device([p, (p[0], (Q - p[1]) % Q)], [scalars[1]] * 2,
                           c=MSM_C, device=device)
    cancel_s = time.perf_counter() - t0
    check(cancel is None, "msm: P and -P do not cancel to the identity")
    for k in total:
        total[k] += fk.LAUNCHES[k]
        check(total[k] > 0, f"msm: {k} was not launched")

    xs, ys = md.upload_points(points[:max(MSM_SIZES)], device)
    add = _msm_add_times(device, xs, ys)
    del xs, ys
    torch.cuda.empty_cache()
    rec = {"c": MSM_C, "windows": (md.SCALAR_BITS + MSM_C - 1) // MSM_C,
           "srs_s": srs_s, "cancel_s": cancel_s,
           "runs": {str(n): r for n, r in runs.items()},
           "add_ms": {str(k): v for k, v in add.items()},
           "launches": total, "wall_s": time.perf_counter() - t_phase}
    emit("msm", **rec)
    return rec


def phase_msm_commits(device) -> dict:
    """Beside the threshold process: ``run_commits_workload`` at k = 13
    with 8 columns on the host, then under ``PTPU_MSM_DEVICE=1`` on the
    card (each run's own oracle check; the card's field launches those
    of 16 full-width MSMs over 2^13 bases), and a k = 12 lockstep whose
    card prove commits through the device MSM, byte-equal to the host
    prove and verifying. Returns the field launches of the card's
    runs."""
    from protocol_tpu_torch.cli.profilecmd import run_commits_workload
    from protocol_tpu_torch.ops import msm_device as md
    from protocol_tpu_torch.ops.kernels import field_kernel as fk

    t_phase = time.perf_counter()
    rec = {}
    total = dict.fromkeys(fk.LAUNCHES, 0)
    for mode in ("host", "device"):
        before = _commit_stage_s("host")
        fk.reset_launches()
        t0 = time.perf_counter()
        with _msm_device_flag(mode == "device"):
            meta = run_commits_workload(k=COMMITS_K, columns=COMMITS_COLUMNS,
                                        device=device)
        wall_s = time.perf_counter() - t0
        stages = {k: v - before.get(k, 0.0)
                  for k, v in _commit_stage_s("host").items()
                  if k.startswith("commit.bench_")}
        rec[mode] = {"wall_s": wall_s, "stages_s": stages,
                     "batched": meta["batched"],
                     "launches": dict(fk.LAUNCHES)}
        for k in total:
            total[k] += fk.LAUNCHES[k]
    per = md.launch_counts(1 << COMMITS_K, MSM_C)
    expect = {k: 2 * COMMITS_COLUMNS * v for k, v in per.items()}
    check(rec["device"]["launches"] == expect,
          f"commits: the card's launches {rec['device']['launches']}, the "
          f"code's count {expect}")
    check(not any(rec["host"]["launches"].values()),
          "commits: the host run launched field kernels")
    emit("msm_commits", k=COMMITS_K, columns=COMMITS_COLUMNS, **rec)

    fk.reset_launches()
    lock = _lockstep(device, MSM_LOCKSTEP_K, msm_device=True)
    lock["launches"] = dict(fk.LAUNCHES)
    for k in total:
        total[k] += fk.LAUNCHES[k]
        check(total[k] > 0, f"msm commits: {k} was not launched")
    emit("msm_lockstep", **lock)
    return {"commits": rec, "lockstep": lock, "launches": total,
            "wall_s": time.perf_counter() - t_phase}


def phase_workloads() -> dict:
    """The profile library's pool workloads at their defaults: host
    proves through a two-worker pool, sharded across it, and across the
    fabric to an in-thread worker, each byte-equal to the direct prove
    (their own checks)."""
    from protocol_tpu_torch.cli import profilecmd as prof

    rec = {}
    for name in ("proofs", "sharded", "fabric"):
        t0 = time.perf_counter()
        meta = getattr(prof, f"run_{name}_workload")()
        rec[name] = {**meta, "wall_s": time.perf_counter() - t0}
    emit("workloads", **rec)
    return rec


def _field_record(name: str, launches: int, err: int, times: dict) -> dict:
    t = times[(name, 262_144)]
    replaces = {"mont_mul": "protocol_tpu/ops/pallas_kernels.py:32",
                "add_mod": "protocol_tpu/ops/fieldops.py:193",
                "sub_mod": "protocol_tpu/ops/fieldops.py:199"}[name]
    return {"name": name, "route": "cuda",
            "source": "protocol_tpu_torch/csrc/field.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


THRESHOLD_CHILD = "--threshold-child"  # internal: phase threshold alone
MSM_CHILD = "--msm-child"  # internal: msm_commits, workloads, sharded_checks


def _msm_child_phases(device) -> dict:
    return {"msm_commits": phase_msm_commits(device),
            "workloads": phase_workloads(),
            "sharded_checks": phase_sharded_checks(device)}


# the phases each child runs, by its flag: (name, phases(device) -> record)
CHILDREN = {THRESHOLD_CHILD: ("threshold", lambda d: phase_threshold(d)),
            MSM_CHILD: ("msm_commits", _msm_child_phases)}


def _start_child(flag: str) -> tuple:
    """A child's phases as a process of their own, beside the host-bound
    phases: ``(child, its directory)``. Its launch counts are its own."""
    name = CHILDREN[flag][0]
    d = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    argv = [sys.executable, ROOT / "chip_smoke.py", flag, d / f"{name}.json"]
    return _Child(argv, d, name, dict(os.environ)), d


def _join_child(child, d: Path, flag: str) -> dict:
    """Wait for a child process; its record, or its failure."""
    name = CHILDREN[flag][0]
    try:
        _, err = child.finish(SMOKE_DEADLINE_S, f"phase {name}")
    except SmokeFailure as e:
        raise SmokeFailure(f"{e}: {child.err_path.read_text()[-3000:]}") \
            from None
    check(child.proc.returncode == 0,
          f"phase {name} exited {child.proc.returncode}: {err[-3000:]}")
    return json.loads((d / f"{name}.json").read_text())


def _run_child(flag: str, device, out: Path) -> int:
    from protocol_tpu_torch.utils import trace

    trace.enable()  # in memory: the phases read the prover's histograms
    try:
        rec = CHILDREN[flag][1](device)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    out.write_text(json.dumps(rec))
    return 0


def _host() -> dict:
    """The host's CPUs as this process sees them, and its load: the
    proof phases' host work scales with them."""
    try:
        quota = Path("/sys/fs/cgroup/cpu.max").read_text().strip()
    except OSError:
        quota = None
    return {"cpus": len(os.sched_getaffinity(0)), "cpu_count": os.cpu_count(),
            "cgroup_cpu_max": quota, "loadavg": list(os.getloadavg())}


def main() -> int:
    global _T0
    import faulthandler

    import torch

    _T0 = time.perf_counter()
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
    if sys.argv[1:2] and sys.argv[1] in CHILDREN:
        return _run_child(sys.argv[1], device, Path(sys.argv[2]))
    from protocol_tpu_torch.utils import trace

    trace.enable()  # in memory: the churn phase reads the build counter
    smi = nvidia_smi_line()
    emit("card", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         host=_host())
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(DUMP_AFTER_S - (t_start - _T0))
    children: dict = {}
    try:
        phase_build()
        # the phases that time kernels run alone on the card
        max_err = phase_kernel_vs_plain(device)
        times = phase_kernel_times(device)
        launches, graph = phase_main_path(device)
        delta = phase_delta(device, graph)
        topics = phase_topics(device, graph)
        sharded = phase_sharded(device, graph)
        del graph
        field_err = phase_field_kernels_vs_plain(device)
        field_times = phase_field_times(device)
        converge_launches = phase_field_converge(device)
        pieces = phase_prove_pieces(device)
        msm = phase_msm(device)
        # the Threshold proofs (host circuit builds and commits, most of
        # a run's wall), and the device MSM's commits and the sharded
        # checks (paced by the host's launches) beside the rest, which
        # times no kernel
        for flag in CHILDREN:
            children[flag] = _start_child(flag)
        t_child = time.perf_counter()
        scenario_launches = phase_scenario(device)
        phase_entry(device)
        phase_cli()
        field_launches = phase_ingest(device)
        scores_launches = phase_scores(device)
        serve_launches, follower_launches = phase_serve(device)
        prove = phase_prove(device, pieces)
        fabric = phase_fabric(device)
        t_rest = time.perf_counter() - t_child
        beside = _join_child(*children[MSM_CHILD], MSM_CHILD)
        msm_commits = beside["msm_commits"]
        emit("msm_commits", **msm_commits, beside_s=t_rest,
             joined_after_s=time.perf_counter() - t_child)
        emit("workloads", **beside["workloads"])
        checks = beside["sharded_checks"]
        emit("sharded_checks", **checks)
        sharded_launches = {k: v + checks["launches"][k]
                            for k, v in sharded["launches"].items()}
        threshold = _join_child(*children[THRESHOLD_CHILD],
                                THRESHOLD_CHILD)
        emit("threshold", **threshold, beside_s=t_rest,
             joined_after_s=time.perf_counter() - t_child)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
        for child, child_dir in children.values():
            child.stop()
            shutil.rmtree(child_dir, ignore_errors=True)
    edge = times[262_144]  # the edge route's first stage: forward, m = T
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
        "launches_by_path": {"converge": launches,
                             "churn": delta["lane_perm_launches"],
                             "topics": topics["lane_perm_launches"],
                             "scenario": scenario_launches,
                             "serve": serve_launches["lane_perm"],
                             "follower": follower_launches["lane_perm"],
                             "sharded": sharded_launches["lane_perm"]},
        "batched": topics["batched_stage"],
    }] + [dict(_field_record(k, field_launches[k], field_err[k],
                             field_times),
               launches_by_path={
                   "ingest": field_launches[k],
                   "scores": scores_launches[k],
                   "serve": serve_launches[k],
                   "follower": follower_launches[k],
                   "prove": prove["launches"][k],
                   "threshold": threshold["launches"][k],
                   "fabric": fabric["launches"][k],
                   "msm": msm["launches"][k],
                   "msm_commits": msm_commits["launches"][k],
                   "sharded": sharded_launches[k],
                   **({"field_converge": converge_launches}
                      if k == "mont_mul" else {})})
          for k in ("mont_mul", "add_mod", "sub_mod")]}), flush=True)
    emit("done", wall_s=time.perf_counter() - t_start, host=_host())
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
