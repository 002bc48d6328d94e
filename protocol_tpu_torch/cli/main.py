"""The port's CLI: the reference's score, proof and service verbs,
``scenario``, ``sparse-scores`` and ``profile`` on torch.

- ``attest``, ``attestations``, ``deploy``, ``show``, ``update`` and
  ``bandada`` are host verbs, copied from the reference CLI
  (``protocol_tpu/cli/main.py``) with the same arguments, files and exit
  codes: the file-persisted local chain (``node_url = "memory"``) or a
  JSON-RPC node, the MNEMONIC env secret, ``config.json``,
  ``attestations.csv`` and ``scores.csv`` under the assets directory.
- ``local-scores`` and ``scores`` take ``--backend {native,torch,
  torch-sparse}`` (the reference's ``native,jax,jax-sparse``): the exact
  path always runs, and a torch backend's float scores must agree with
  it within 1e-3. ``--batched-ingest`` recovers the signers on the card
  (the field kernels). ``--device`` names the torch device of both; a
  verb that needs the card and has none fails, it never runs on the CPU
  unasked.
- ``scenario`` is the adversarial harness (``cli/scenariocmd.py``):
  ``list``, ``run`` (``--device``), ``report``.
- ``sparse-scores`` converges a raw edge-list trust graph: the
  reference CLI's verb, with the same arguments, output CSV and exit
  codes, plus ``--device``. ``--checkpoint-dir`` runs the sharded
  checkpointed converge (``parallel/``) over a mesh of every GPU, or of
  the one device ``--device`` names.
- ``profile`` runs a workload under the instrument layer and prints the
  per-stage report (``cli/profilecmd.py``): the reference's arguments
  plus ``--device``; ``--workload refresh`` runs locally, ``daemon``
  captures on a live ``serve`` daemon (``--url``), and ``prove`` times
  one proof through ``prove_auto`` with its stage coverage check.
- ``kzg-params``, ``et-proving-key``, ``et-proof`` and ``et-verify``
  are the reference's proof verbs, with its flags, files and exit codes
  (``et-verify`` exits 1 on an invalid proof). ``et-proof`` also takes
  ``--device``: rounds 3–4 of the prover run on the card (its
  ``DeviceProver``), or on the host with ``--device cpu``; without a
  card and without ``--device cpu`` it exits 1 naming the flag.
  ``kzg-params``, ``et-proving-key`` and ``et-verify`` are host work
  in both packages and take no card. The artifacts are the reference
  package's, byte for byte, both ways.
- ``et-verifier`` writes the deployable Yul verifier of the EigenTrust
  proof (``et-verifier.yul``); ``--check`` replays the written proof in
  the in-repo Yul EVM and prints its gas, ``--rpc URL`` deploys it to a
  JSON-RPC node (the devnet: ``client.mocknode``) and verifies on-chain.
  Host work, no card.
- ``th-proving-key``, ``th-proof --peer --threshold`` and ``th-verify``
  are the Threshold verbs at ``TH_PARAMS_K`` = 21, the reference's.
  ``th-proving-key`` proves a dummy inner EigenTrust snark and
  ``th-proof`` proves the inner snark and the Threshold circuit that
  aggregates it: both take ``--device`` as ``et-proof`` does and, with
  no card and no ``--device cpu``, exit 1 naming the flag.
  ``th-verify`` (the PLONK verify plus the deferred KZG decide) is host
  work.

- ``serve`` runs the trust-scores daemon (``service``): the reference's
  flags plus ``--device``; without a card and without ``--device cpu``
  it fails before it binds a port or touches the state dir.
  ``--follow LEADER_URL`` runs a read replica (``FollowerService``)
  whose refresh and batched signer recovery run on that device;
  ``--shard-proves 1`` lends idle pool workers into a running prove's
  work units and ``--fabric 1`` publishes them under
  ``<state-dir>/fabric`` for external ``prove-worker`` processes.
- ``prove-worker`` is the fabric's external worker (``--state-dir`` on
  the same box, ``--url`` across boxes): its executors are host work on
  the C++ prover core, so it takes no ``--device``; it ships its
  telemetry to the leader, whose ``/fleet`` lists it.
- ``store inspect|compact`` and ``obs`` are the reference's verbs; the
  store's files and the trace streams are the same in both packages.
- ``fleet``, ``slo`` and ``incident`` render a live daemon's ``/fleet``,
  ``/slo`` and ``/incidents`` (host work, no ``--device``; ``slo`` exits
  1 while an alert is latched).
"""

from __future__ import annotations

import argparse
import csv
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

from ..client import (
    AttestationRecord,
    Client,
    ClientConfig,
    CSVFileStorage,
    JSONFileStorage,
    LocalChain,
    ScoreRecord,
)
from ..utils.errors import EigenError
from .fs import EigenFile, assets_dir, load_mnemonic

_DEVICE_HELP = "torch device (default: cuda; 'cpu' to run on the CPU)"
ET_PARAMS_K = 21
TH_PARAMS_K = 21


class CliError(Exception):
    """A user-facing failure: printed as ``error: ...``, exit code 1."""


def cli_device(name):
    """The torch device a verb runs on: ``--device`` if given, else the
    card; with neither, a clean error instead of a silent CPU run."""
    from ..device import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise CliError("no CUDA device available; pass --device cpu to run "
                       "on the CPU") from e


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="protocol-tpu-torch",
        description="EigenTrust scores on torch (CUDA by default)")
    parser.add_argument("--assets",
                        help="assets directory (default $EIGEN_ASSETS or "
                             "./assets)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("attest", help="sign and publish an attestation")
    p.add_argument("--to", required=True, help="attested peer address (0x..)")
    p.add_argument("--score", required=True, type=int,
                   help="score value 0..255")
    p.add_argument("--message", default="0x" + "00" * 32,
                   help="optional 32-byte message")

    sub.add_parser("attestations",
                   help="fetch attestations into attestations.csv")

    p = sub.add_parser("bandada",
                       help="threshold-gated Bandada group membership")
    p.add_argument("--action", choices=["add", "remove"], required=True)
    p.add_argument("--identity-commitment", required=True)
    p.add_argument("--address", required=True, help="peer address to check")

    sub.add_parser("deploy",
                   help="deploy the AttestationStation (local chain)")

    def _et_shape_args(p):
        p.add_argument("--shape", choices=["default", "tiny"],
                       default="default",
                       help="circuit instantiation: default = the "
                            "EigenTrust4 shape (k=21 params), tiny = "
                            "the 2-peer/2-iteration dev shape (k=20)")

    p = sub.add_parser("et-proof", help="generate the EigenTrust proof")
    _et_shape_args(p)
    p.add_argument("--transcript", choices=["poseidon", "keccak"],
                   default="poseidon",
                   help="keccak emits the on-chain-cheap proof; poseidon "
                        "keeps recursion parity with the aggregator")
    p.add_argument("--device", default=None,
                   help=_DEVICE_HELP + "; rounds 3-4 of the prover run "
                        "there (cpu: the host prover)")
    p = sub.add_parser("et-proving-key",
                       help="generate the EigenTrust proving key")
    _et_shape_args(p)
    p = sub.add_parser("et-verify", help="verify the EigenTrust proof")
    _et_shape_args(p)
    p.add_argument("--transcript", choices=["auto", "poseidon", "keccak"],
                   default="auto",
                   help="auto reads et-proof.meta.json (falls back to "
                        "poseidon) so a keccak proof can't be replayed "
                        "under the wrong hash by default")
    p = sub.add_parser(
        "et-verifier",
        help="emit the deployable Yul/EVM verifier (et-verifier.yul)")
    _et_shape_args(p)
    p.add_argument("--transcript", choices=["auto", "poseidon", "keccak"],
                   default="auto",
                   help="auto follows et-proof.meta.json, else keccak "
                        "(the on-chain-cheap variant)")
    p.add_argument("--check", action="store_true",
                   help="replay the written et-proof against the "
                        "generated verifier in the in-repo EVM and "
                        "print the gas")
    p.add_argument("--rpc", metavar="URL",
                   help="deploy the verifier to this JSON-RPC node and "
                        "verify the written et-proof ON-CHAIN via "
                        "eth_call (devnet: client.mocknode)")

    p = sub.add_parser("th-proof", help="generate the Threshold proof")
    p.add_argument("--peer", required=True, help="peer address (0x..)")
    p.add_argument("--threshold", type=int, required=True)
    p.add_argument("--device", default=None,
                   help=_DEVICE_HELP + "; rounds 3-4 of both proves run "
                        "there (cpu: the host prover)")
    p = sub.add_parser("th-proving-key",
                       help="generate the Threshold proving key")
    p.add_argument("--device", default=None,
                   help=_DEVICE_HELP + "; rounds 3-4 of the dummy inner "
                        "EigenTrust prove run there (cpu: the host "
                        "prover)")
    sub.add_parser("th-verify", help="verify the Threshold proof")

    p = sub.add_parser("kzg-params", help="generate KZG params")
    p.add_argument("--k", type=int, required=True,
                   help="circuit degree 2^k rows")

    for verb, text in (("local-scores", "score attestations.csv offline"),
                       ("scores", "fetch attestations and compute scores")):
        p = sub.add_parser(verb, help=text)
        p.add_argument("--backend", choices=["native", "torch",
                                             "torch-sparse"],
                       default="native",
                       help="native: the exact rational path alone; torch "
                            "/ torch-sparse: also the float path on the "
                            "device, held to 1e-3 of the exact scores")
        p.add_argument("--batched-ingest", action="store_true",
                       help="recover attestation signers on the device in "
                            "one batch")
        p.add_argument("--device", default=None, help=_DEVICE_HELP)

    p = sub.add_parser(
        "serve",
        help="run the long-running trust-scores service (chain tailer, "
             "incremental refresh, proof job queue, HTTP API)")
    p.add_argument("--host", default=None, help="bind host (default "
                   "127.0.0.1; PTPU_SERVE_HOST)")
    p.add_argument("--port", type=int, default=None,
                   help="bind port (0 = ephemeral; default 8799)")
    p.add_argument("--poll-interval", type=float, default=None,
                   help="seconds between chain polls")
    p.add_argument("--tol", type=float, default=None,
                   help="refresh stopping tolerance (relative L1)")
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("--queue-capacity", type=int, default=None,
                   help="proof job backpressure bound (the shedding "
                        "watermark defaults to it)")
    p.add_argument("--workers", type=int, default=None,
                   help="proof pool workers (default 0 = one per CUDA "
                        "device; host-path workers on a CPU box)")
    p.add_argument("--shard-proves", type=int, default=None,
                   metavar="0|1",
                   help="1: fan a single prove's work units out to idle "
                        "pool workers (byte-identical proofs; default 0)")
    p.add_argument("--fabric", type=int, default=None, metavar="0|1",
                   help="1: publish sharded-prove work units under "
                        "<state-dir>/fabric/ so external prove-worker "
                        "processes lend into running proves "
                        "(needs --shard-proves 1 and a state dir; "
                        "default 0)")
    p.add_argument("--fabric-lease-ttl", type=float, default=None,
                   help="seconds an external worker's unit lease "
                        "lives without a heartbeat before the unit "
                        "is reclaimed (default 5)")
    p.add_argument("--shape", choices=["default", "tiny"], default=None,
                   help="circuit shape served by proof jobs")
    p.add_argument("--transcript", choices=["poseidon", "keccak"],
                   default=None, help="default et-proof transcript")
    p.add_argument("--state-dir", default=None,
                   help="durable state store root (attestation WAL, "
                        "graph snapshots, proof artifacts, operator "
                        "cache; default <assets>/service-state) — "
                        "restarts replay it instead of re-fetching "
                        "pre-cursor blocks")
    p.add_argument("--checkpoint-dir", default=None,
                   help="block-cursor checkpoint directory "
                        "(default <state-dir>/cursor)")
    p.add_argument("--follow", default=None, metavar="LEADER_URL",
                   help="run as a READ REPLICA of a leader daemon: "
                        "restore from its /repl/snapshot, tail its "
                        "shipped WAL (/repl/wal), refresh and serve "
                        "/scores //score/<addr> //bundle hermetically "
                        "(no chain tailer, no proof pool; POST /proofs "
                        "answers 503)")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)

    p = sub.add_parser(
        "prove-worker",
        help="lend this process into a serve --fabric daemon's running "
             "proves: poll the fabric for published work units "
             "(commit MSM batches, quotient row chunks, opening "
             "folds), lease + execute + publish results — "
             "byte-identical placement, lease-reclaim crash safety")
    p.add_argument("--state-dir", default=None,
                   help="the DAEMON's state dir (the fabric lives at "
                        "<state-dir>/fabric; default "
                        "<assets>/service-state) — same-box, "
                        "shared-filesystem mode")
    p.add_argument("--url", default=None,
                   help="daemon base URL (http://host:port) — "
                        "cross-box mode over the /fabric HTTP surface "
                        "instead of a shared filesystem")
    p.add_argument("--name", default=None,
                   help="worker name carried on leases, results and "
                        "the prove.shard spans of units this process "
                        "executes (default fw<pid>)")
    p.add_argument("--poll", type=float, default=0.05,
                   help="seconds between idle fabric polls")
    p.add_argument("--lease-ttl", type=float, default=5.0,
                   help="lease/heartbeat TTL seconds (match the "
                        "daemon's --fabric-lease-ttl)")
    p.add_argument("--max-units", type=int, default=None,
                   help="exit after executing this many units "
                        "(default: run until signalled)")
    p.add_argument("--idle-exit", type=float, default=None,
                   help="exit after this many seconds with no "
                        "claimable unit (default: poll forever)")

    p = sub.add_parser(
        "obs",
        help="observability tooling: validate a JSONL trace stream "
             "(PROTOCOL_TPU_TRACE=<path> or the serve daemon's "
             "stream, from either package) and render its span-"
             "aggregate summary "
             "(count/p50/p95 per stage)")
    p.add_argument("path", help="JSONL trace stream to read")
    p.add_argument("--jsonl", action="append", default=[],
                   metavar="PATH", dest="extra_jsonl",
                   help="merge additional JSONL streams into the view "
                        "(repeatable) — e.g. a prove-worker's --trace "
                        "stream joined with the leader's, so one job's "
                        "trace id chains across processes")
    p.add_argument("--follow", action="store_true",
                   help="tail the stream, printing records as they land "
                        "(Ctrl-C to stop)")
    p.add_argument("--trace-id", dest="trace_id",
                   help="print the span/event chain for one trace id "
                        "(attestation digest prefix, job id — including "
                        "its prover-stage spans and the pool worker "
                        "that executed them, request id)")

    p = sub.add_parser(
        "fleet",
        help="fleet observability: render a live leader's /fleet "
             "registry as an operator table — one row per known "
             "instance (leader, followers, prove-workers) with role, "
             "freshness, repl lag and report age; dead instances stay "
             "listed (staleness-honest), flagged inactive")
    p.add_argument("--url", required=True,
                   help="leader daemon base URL (http://host:port)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /fleet JSON instead of the table")

    p = sub.add_parser(
        "slo",
        help="SLO burn rates: render a live daemon's /slo evaluation — "
             "per-objective fast/slow-window burn, in-budget flags and "
             "latched alerts; exits 1 while any alert is latched")
    p.add_argument("--url", required=True,
                   help="daemon base URL (http://host:port) — leader "
                        "or follower (each evaluates its own SLOs)")
    p.add_argument("--json", action="store_true",
                   help="print the raw /slo JSON instead of the table")

    p = sub.add_parser(
        "incident",
        help="incident autopsies: list a live daemon's captured "
             "flight-recorder bundles (/incidents), or render one as a "
             "human-readable autopsy — trigger, burn timeline, top "
             "spans, device cost per plan, named-thread stacks")
    p.add_argument("--url", required=True,
                   help="daemon base URL (http://host:port) — leader "
                        "or follower (each keeps its own store)")
    p.add_argument("--id", default=None,
                   help="incident id to render (default: list the "
                        "index; 'latest' renders the newest bundle)")
    p.add_argument("--json", action="store_true",
                   help="print the raw JSON instead of the autopsy")

    p = sub.add_parser(
        "store",
        help="inspect or compact the serve daemon's durable state store")
    p.add_argument("action", choices=["inspect", "compact"],
                   help="inspect: WAL/snapshot/proof-artifact summary; "
                        "compact: fold latest-wins duplicate "
                        "attestations into a fresh WAL segment "
                        "(run with the daemon stopped)")
    p.add_argument("--state-dir", default=None,
                   help="state store root (default "
                        "<assets>/service-state)")

    p = sub.add_parser(
        "scenario",
        help="adversarial scenario harness: list topologies, run a "
             "seeded {topology x semiring} robustness experiment "
             "(deterministic JSON), or render a saved report")
    p.add_argument("action", choices=["list", "run", "report"],
                   help="list: topology catalog + knobs; run: one "
                        "seeded run (byte-identical JSON per seed); "
                        "report: human summary of a saved run JSON")
    p.add_argument("--topology", default="sybil-ring",
                   help="attack family (see 'scenario list')")
    p.add_argument("--peers", type=int, default=10_000,
                   help="total peer count (honest + attackers)")
    p.add_argument("--attacker-fraction", type=float, default=0.1,
                   help="fraction of peers controlled by the attacker")
    p.add_argument("--semiring", choices=["plusmul", "maxplus"],
                   default="plusmul",
                   help="sweep algebra: plusmul = EigenTrust mass "
                        "propagation, maxplus = bottleneck (widest-"
                        "path) trust through the same operator")
    p.add_argument("--seed", type=int, default=0,
                   help="topology RNG seed; same seed -> byte-identical "
                        "report")
    p.add_argument("--alpha", type=float, default=0.1,
                   help="pre-trust damping (>0 makes the iteration "
                        "bound spectrum-free)")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--engine", choices=["auto", "sparse", "routed"],
                   default="auto",
                   help="SpMV engine; auto picks routed past 20M edges")
    p.add_argument("--no-baseline", action="store_true",
                   help="skip the attack-free control converge (rank "
                        "displacement then reads as zero)")
    p.add_argument("--timing", action="store_true",
                   help="include wall-clock timing fields (breaks "
                        "byte-identical reproducibility, so opt-in)")
    p.add_argument("--out", help="also write the report JSON here "
                                 "(relative to assets)")
    p.add_argument("--json", help="report: saved run JSON to render")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)

    sub.add_parser("show", help="print the current config")

    p = sub.add_parser("update", help="update a config field")
    for fld in ClientConfig.__dataclass_fields__:
        p.add_argument(f"--{fld.replace('_', '-')}", dest=fld)

    p = sub.add_parser(
        "sparse-scores",
        help="converge a raw edge-list trust graph (the scale path)")
    p.add_argument("--edges", required=True,
                   help="CSV of src,dst,weight rows (no header)")
    p.add_argument("--n", type=int, required=True, help="number of peers")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="relative L1 stopping tolerance")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="pre-trust damping factor (0 = reference semantics)")
    p.add_argument("--max-iterations", type=int, default=500)
    p.add_argument("--initial-score", type=float, default=1000.0)
    p.add_argument("--checkpoint-dir",
                   help="sharded checkpointed mode: converge over a mesh "
                        "of every GPU (or the one --device), saving the "
                        "scores every --checkpoint-every sweeps here and "
                        "resuming from the newest")
    p.add_argument("--checkpoint-every", type=int, default=25)
    p.add_argument("--engine", choices=["auto", "routed", "gather"],
                   default="auto",
                   help="SpMV engine: 'routed' compiles the edge "
                        "permutation to a Clos lane-shuffle network "
                        "(one-time plan build); 'auto' picks it beyond "
                        "100K peers when the native planner builds")
    p.add_argument("--operator-cache",
                   help="directory for compiled routed operators, keyed "
                        "on the edge-list digest (same files as the "
                        "reference CLI's)")
    p.add_argument("--out", default="sparse-scores.csv",
                   help="output CSV (peer_id,score), relative to assets")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)

    p = sub.add_parser(
        "profile",
        help="run a workload under sync-span tracing (+ optional "
             "torch.profiler capture) and emit a merged per-stage report")
    p.add_argument("--workload", choices=["prove", "refresh", "daemon"],
                   default="refresh",
                   help="prove: keygen + prove a synthetic circuit "
                        "through prove_auto on --device; refresh: "
                        "synthetic trust-graph converge through a "
                        "backend; daemon: capture on a live serve daemon "
                        "(--url)")
    p.add_argument("--k", type=int, default=7,
                   help="prove: domain exponent (synthetic circuit)")
    p.add_argument("--gates", type=int, default=64,
                   help="prove: synthetic gate count")
    p.add_argument("--n", type=int, default=2000,
                   help="refresh: peer count")
    p.add_argument("--edges-per-node", type=int, default=4,
                   help="refresh: BA attachment degree")
    p.add_argument("--engine", choices=["gather", "routed"],
                   default="gather", help="refresh: SpMV engine")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="refresh: stopping tolerance")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the workload N times (warm steady-state)")
    p.add_argument("--url", help="daemon: base URL of the live daemon")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="daemon: capture window length")
    p.add_argument("--xprof", metavar="DIR",
                   help="capture a torch.profiler timeline into DIR, "
                        "joinable with the span stream by trace id")
    p.add_argument("--jsonl", metavar="PATH",
                   help="stream spans as JSONL to PATH")
    p.add_argument("--json", metavar="PATH",
                   help="write the per-stage report as JSON")
    p.add_argument("--no-sync", action="store_true",
                   help="keep asynchronous launches instead of sync-span "
                        "attribution")
    p.add_argument("--min-coverage", type=float, default=0.0,
                   help="exit 1 unless the named prover stages cover at "
                        "least this fraction of the prove wall time")
    p.add_argument("--device", default=None, help=_DEVICE_HELP)
    return parser


def _read_edges(path: Path, n: int):
    src_l, dst_l, val_l = [], [], []
    try:
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0].startswith("#"):
                    continue
                src_l.append(int(row[0]))
                dst_l.append(int(row[1]))
                val_l.append(float(row[2]) if len(row) > 2 else 1.0)
    except (OSError, ValueError, IndexError) as e:
        raise CliError(f"bad edge list: {e}") from e
    if not src_l:
        raise CliError("edge list is empty")
    src, dst, val = np.asarray(src_l), np.asarray(dst_l), np.asarray(val_l)
    if src.min() < 0 or dst.min() < 0 or src.max() >= n or dst.max() >= n:
        raise CliError(f"edge endpoints must be in [0, {n})")
    return src, dst, val


def _cached_operator(args, assets: Path, kind: str, num_shards: int, src,
                     dst, val, load, build):
    """Load the compiled operator from ``--operator-cache``, else build
    (and store) it. The key is the reference CLI's (the edge-list digest
    and the build geometry), so a cache written by either package serves
    both; an unreadable entry is rebuilt and overwritten."""
    if not args.operator_cache:
        return build()
    h = hashlib.sha256()
    h.update(f"{kind}:v1:n={args.n}:D={num_shards}".encode())
    for a in (src, dst, val):
        h.update(np.ascontiguousarray(a).tobytes())
    cache_dir = Path(args.operator_cache)
    if not cache_dir.is_absolute():
        cache_dir = assets / cache_dir
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"{kind}_{h.hexdigest()[:24]}.npz"
    if path.exists():
        try:
            return load(path)
        except (OSError, ValueError, KeyError) as e:
            print(f"warning: ignoring unreadable operator cache {path}: {e}",
                  file=sys.stderr)
    op = build()
    op.save(path)
    return op


def _sparse_scores_checkpointed(args, assets: Path, src, dst, val):
    """``--checkpoint-dir``: the sharded adaptive converge in chunks of
    ``--checkpoint-every`` sweeps, resumed from the newest checkpoint
    there. The mesh is every GPU, or the one device ``--device`` names;
    the engine rule, the routed operator cache and the errors are the
    reference CLI's."""
    import torch

    from .. import native
    from ..parallel import (
        build_sharded_operator,
        build_sharded_routed_operator,
        make_mesh,
        sharded_converge_checkpointed,
    )
    from ..parallel.routed import ShardedRoutedOperator
    from ..utils import trace
    from ..utils.checkpoint import CheckpointManager

    ck_dir = Path(args.checkpoint_dir)
    if not ck_dir.is_absolute():
        ck_dir = assets / ck_dir
    device = cli_device(args.device)  # no card: the error naming --device
    mesh = make_mesh() if args.device is None else make_mesh(
        devices=[device])
    n_dev = mesh.size
    engine = args.engine
    if engine == "auto":
        engine = ("routed" if args.n >= 100_000 and native.available()
                  and 128 % n_dev == 0 else "gather")
    if engine == "routed" and 128 % n_dev != 0:
        raise EigenError(
            "validation_error",
            f"routed engine needs a device count dividing 128, "
            f"have {n_dev}")
    if engine == "routed":
        sop = _cached_operator(
            args, assets, "sharded_routed", n_dev, src, dst, val,
            lambda p: ShardedRoutedOperator.load(p, num_shards=n_dev),
            lambda: build_sharded_routed_operator(args.n, src, dst, val,
                                                  num_shards=n_dev))
        s0 = torch.from_numpy(sop.initial_scores(args.initial_score,
                                                 dtype=np.float32))
    else:
        sop = build_sharded_operator(args.n, src, dst, val,
                                     num_shards=n_dev)
        s0 = sop.initial_scores(args.initial_score, dtype=torch.float32)
    try:
        with trace.span("cli.sparse_scores", mode="sharded", n=args.n,
                        engine=engine):
            scores, iters, delta = sharded_converge_checkpointed(
                sop, s0, mesh, CheckpointManager(str(ck_dir)),
                tol=args.tol, max_iterations=args.max_iterations,
                alpha=args.alpha, checkpoint_every=args.checkpoint_every)
    except ValueError as e:
        # bad checkpoint_every / stale-checkpoint mismatch on resume
        raise EigenError("validation_error", str(e)) from e
    if engine == "routed":
        scores = sop.scores_for_nodes(scores)
    else:
        scores = scores.cpu().numpy()[: args.n]
    return scores, iters, delta


def handle_sparse_scores(args, files, config) -> int:
    from .. import native
    from ..backend import TorchRoutedBackend, TorchSparseBackend

    assets = files.assets
    edges_path = Path(args.edges)
    if not edges_path.is_absolute():
        edges_path = assets / edges_path
    src, dst, val = _read_edges(edges_path, args.n)

    if args.checkpoint_dir:
        scores, iters, delta = _sparse_scores_checkpointed(args, assets, src,
                                                           dst, val)
    else:
        from ..ops.routed import RoutedOperator, build_routed_operator

        engine = args.engine
        if engine == "auto":
            engine = ("routed" if args.n >= 100_000 and native.available()
                      else "gather")
        backend = (TorchRoutedBackend if engine == "routed"
                   else TorchSparseBackend)(device=cli_device(args.device))
        valid = np.ones(args.n, dtype=bool)
        extra = {}
        if engine == "routed":
            extra["operator"] = _cached_operator(
                args, assets, "routed", 1, src, dst, val,
                RoutedOperator.load,
                lambda: build_routed_operator(args.n, src, dst, val, valid))
        scores, iters, delta = backend.converge_edges(
            args.n, src, dst, val, valid, args.initial_score,
            args.max_iterations, tol=args.tol, alpha=args.alpha, **extra)

    out_path = Path(args.out)
    if not out_path.is_absolute():
        out_path = assets / out_path
    with open(out_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["peer_id", "score"])
        for i, s in enumerate(np.asarray(scores)[: args.n]):
            writer.writerow([i, repr(float(s))])
    converged = delta <= args.tol
    print(f"{args.n} peers, {len(src)} edges: "
          f"{'converged' if converged else 'NOT converged'} after "
          f"{int(iters)} iterations (delta {float(delta):.2e})")
    print(f"saved {out_path}")
    return 0 if converged else 1


# --- context helpers (the reference CLI's) ---------------------------------


def _load_config(files: EigenFile) -> ClientConfig:
    path = files.config_json()
    if path.exists():
        return ClientConfig.from_dict(JSONFileStorage(path).load())
    return ClientConfig()


def _save_config(files: EigenFile, config: ClientConfig) -> None:
    JSONFileStorage(files.config_json()).save(config.to_dict())


def _make_client(files: EigenFile, config: ClientConfig,
                 batched_ingest: bool = False, device=None,
                 shape=None) -> Client:
    chain = None
    if config.node_url == "memory":
        path = files.chain_json()
        if path.exists():
            chain = LocalChain.from_json(JSONFileStorage(path).load())
        else:
            chain = LocalChain()
    kwargs = {}
    if shape is not None:
        kwargs["num_neighbours"] = shape.num_neighbours
        kwargs["num_iterations"] = shape.num_iterations
        kwargs["initial_score"] = shape.initial_score
    return Client(config, load_mnemonic(), chain=chain,
                  batched_ingest=batched_ingest, device=device, **kwargs)


def _save_chain(files: EigenFile, client: Client) -> None:
    if isinstance(client.chain, LocalChain):
        JSONFileStorage(files.chain_json()).save(client.chain.to_json())


def _parse_hex(value: str, length: int, what: str) -> bytes:
    try:
        raw = bytes.fromhex(value.removeprefix("0x"))
    except ValueError as e:
        raise EigenError("parsing_error",
                         f"bad {what} (not hex): {value}") from e
    if len(raw) != length:
        raise EigenError("parsing_error",
                         f"bad {what} (need {length} bytes): {value}")
    return raw


def _parse_address(value: str) -> bytes:
    return _parse_hex(value, 20, "address")


def _load_attestations(files: EigenFile) -> list:
    storage = CSVFileStorage(files.attestations_csv(), AttestationRecord)
    return [record.to_signed() for record in storage.load()]


def _fetch_attestations(files: EigenFile, client: Client) -> list:
    atts = client.get_attestations()
    records = [AttestationRecord.from_signed(a) for a in atts]
    CSVFileStorage(files.attestations_csv(), AttestationRecord).save(records)
    return atts


def _write_scores(files: EigenFile, scores: list) -> None:
    records = [ScoreRecord.from_score(s) for s in scores]
    CSVFileStorage(files.scores_csv(), ScoreRecord).save(records)


def _compute_scores(client: Client, atts: list, backend_name: str,
                    device=None) -> list:
    """Score through the chosen ConvergeBackend; 'native' is the exact
    reference path, 'torch'/'torch-sparse' run the float path on
    ``device`` and are held to the exact rational scores. One circuit
    setup serves both paths (per-attestation ECDSA recovery dominates)."""
    setup = client.et_circuit_setup(atts)
    scores = client.scores_from_setup(setup)
    if backend_name != "native":
        from ..backend import TorchDenseBackend, TorchSparseBackend
        from ..utils import trace

        backend = (TorchDenseBackend if backend_name == "torch"
                   else TorchSparseBackend)(device=device)
        matrix, _ = setup.opinion
        with trace.span("converge.backend", backend=backend_name):
            float_scores = backend.converge(
                matrix, client.initial_score, client.num_iterations
            )
        for i, score in enumerate(scores):
            ratio = float(score.ratio)
            dev = float(float_scores[i])
            if abs(dev - ratio) > 1e-3 * max(ratio, 1.0):
                raise EigenError(
                    "verification_error",
                    f"backend {backend_name} diverged from the exact path at "
                    f"peer {i}: {dev} vs {ratio}",
                )
    return scores


# --- handlers ---------------------------------------------------------------


def handle_attest(args, files, config):
    client = _make_client(files, config)
    tx = client.attest(
        _parse_address(args.to),
        args.score,
        _parse_hex(args.message, 32, "message"),
    )
    _save_chain(files, client)
    print(f"attestation submitted: {tx}")


def handle_attestations(args, files, config):
    client = _make_client(files, config)
    atts = _fetch_attestations(files, client)
    print(f"saved {len(atts)} attestations to {files.attestations_csv()}")


def handle_scores(args, files, config, local: bool):
    # the card is checked before anything is fetched or written
    device = None
    if args.backend != "native" or args.batched_ingest:
        device = cli_device(args.device)
    client = _make_client(files, config, batched_ingest=args.batched_ingest,
                          device=device)
    atts = (_load_attestations(files) if local
            else _fetch_attestations(files, client))
    scores = _compute_scores(client, atts, args.backend, device)
    _write_scores(files, scores)
    for s in scores:
        print(f"0x{s.address.hex()}  {float(s.ratio):.6f}")
    print(f"saved {len(scores)} scores to {files.scores_csv()}")


def handle_bandada(args, files, config):
    from .bandada import BandadaApi

    storage = CSVFileStorage(files.scores_csv(), ScoreRecord)
    target = args.address.lower()
    record = next(
        (r for r in storage.load() if r.peer_address.lower() == target), None
    )
    if record is None:
        raise EigenError("validation_error", f"no score for {args.address}")
    threshold = int(config.band_th)
    score = int(record.numerator) // int(record.denominator)
    if args.action == "add":
        if score < threshold:
            raise EigenError(
                "validation_error",
                f"score {score} below band threshold {threshold}",
            )
        BandadaApi(config.band_url).add_member(
            config.band_id, args.identity_commitment
        )
        print(f"added {args.identity_commitment} to group {config.band_id}")
    else:
        BandadaApi(config.band_url).remove_member(
            config.band_id, args.identity_commitment
        )
        print(f"removed {args.identity_commitment} from group "
              f"{config.band_id}")


def handle_deploy(args, files, config):
    from ..utils.keccak import keccak256

    if config.node_url == "memory":
        # the reference CLI's local address, so both packages agree
        address = keccak256(b"protocol_tpu.attestation_station")[12:]
        config.as_address = "0x" + address.hex()
        _save_config(files, config)
        print(f"local AttestationStation at {config.as_address}")
        return
    # live node: sign and send a creation transaction carrying the
    # vendored AttestationStation bytecode (reference: eth.rs:18-25,
    # bytecode att_station.rs:119)
    from ..client.chain import RpcChain
    from ..client.eth import ecdsa_keypairs_from_mnemonic

    keypair = ecdsa_keypairs_from_mnemonic(load_mnemonic(), 1)[0]
    chain = RpcChain.deploy_signed(config.node_url, keypair,
                                   chain_id=int(config.chain_id))
    config.as_address = "0x" + chain.contract_address.hex()
    _save_config(files, config)
    print(f"deployed AttestationStation at {config.as_address}")


def handle_update(args, files, config):
    changed = []
    for fld in ClientConfig.__dataclass_fields__:
        value = getattr(args, fld, None)
        if value is not None:
            setattr(config, fld, int(value) if fld == "chain_id" else value)
            changed.append(fld)
    if not changed:
        raise EigenError("config_error", "no config fields given")
    _save_config(files, config)
    print(f"updated: {', '.join(changed)}")


def handle_show(args, files, config):
    print(json.dumps(config.to_dict(), indent=2))


def handle_kzg_params(args, files, config):
    from ..zk import api as zk

    data = zk.generate_kzg_params(args.k)
    path = files.kzg_params(args.k)
    path.write_bytes(data)
    print(f"wrote {path} ({len(data)} bytes)")


def _et_shape(args):
    """(CircuitShape, params_k) for the --shape flag; "tiny" is the
    2-peer dev instantiation whose 790k rows fit a k=20 SRS."""
    from ..zk.api import DEFAULT_SHAPE, TINY_SHAPE

    if getattr(args, "shape", "default") == "tiny":
        return TINY_SHAPE, 20
    return DEFAULT_SHAPE, ET_PARAMS_K


def handle_et_pk(args, files, config):
    from ..zk import api as zk

    shape, params_k = _et_shape(args)
    params = files.read(files.kzg_params(params_k))
    pk = zk.generate_et_pk(params, shape=shape)
    files.et_proving_key().write_bytes(pk)
    print(f"wrote {files.et_proving_key()}")


def handle_et_proof(args, files, config):
    """The reference's verb, with rounds 3–4 on ``--device``: the card
    is settled first, so a box without one fails before any work."""
    from ..zk import api as zk

    device = cli_device(args.device)
    shape, params_k = _et_shape(args)
    client = _make_client(files, config, device=device, shape=shape)
    atts = _load_attestations(files)
    setup = client.et_circuit_setup(atts)
    params = files.read(files.kzg_params(params_k))
    pk = files.read(files.et_proving_key())
    proof = zk.generate_et_proof(params, pk, setup, shape=shape,
                                 transcript=args.transcript, device=device)
    files.et_proof().write_bytes(proof)
    files.et_public_inputs().write_bytes(setup.pub_inputs.to_bytes())
    files.et_proof_meta().write_text(
        json.dumps({"transcript": args.transcript}))
    print(f"wrote {files.et_proof()} and {files.et_public_inputs()}")


def _resolve_transcript(args, files, fallback: str) -> str:
    if args.transcript != "auto":
        return args.transcript
    meta = files.et_proof_meta()
    if meta.exists():
        try:
            return json.loads(meta.read_text()).get("transcript", fallback)
        except (ValueError, OSError):
            pass
    return fallback


def handle_et_verify(args, files, config):
    from ..zk import api as zk

    shape, params_k = _et_shape(args)
    transcript = _resolve_transcript(args, files, "poseidon")
    params = files.read(files.kzg_params(params_k))
    pk = files.read(files.et_proving_key())
    proof = files.read(files.et_proof())
    pub_inputs = files.read(files.et_public_inputs())
    ok = zk.verify_et(params, pk, pub_inputs, proof, shape=shape,
                      transcript=transcript)
    print("EigenTrust proof: VALID" if ok else "EigenTrust proof: INVALID")
    return 0 if ok else 1


def handle_et_verifier(args, files, config):
    """Emit the deployable Yul verifier; --check replays the written
    proof artifacts through the in-repo EVM (yellow-paper gas) — the
    full on-chain flow, drivable end-to-end with shipped tools."""
    from ..zk import api as zk

    shape, params_k = _et_shape(args)
    transcript = _resolve_transcript(args, files, "keccak")
    params = files.read(files.kzg_params(params_k))
    pk = files.read(files.et_proving_key())
    code = zk.gen_et_evm_verifier(params, pk, transcript=transcript)
    files.et_verifier().write_text(code)
    print(f"wrote {files.et_verifier()}")
    if getattr(args, "rpc", None):
        # deploy to the node and verify ON-CHAIN over JSON-RPC: the
        # devnet executes the Yul through its EVM (mocknode), so this
        # is the reference's Anvil loop, not a local library replay
        from ..client.chain import VerifierContract
        from ..client.eth import ecdsa_keypairs_from_mnemonic

        proof = files.read(files.et_proof())
        pub_inputs = files.read(files.et_public_inputs())
        calldata = zk.et_evm_calldata(pub_inputs, proof, shape=shape)
        kp = ecdsa_keypairs_from_mnemonic(load_mnemonic(), 1)[0]
        contract = VerifierContract.deploy_signed(args.rpc, kp, code)
        ok = contract.verify(calldata)
        gas = contract.estimate_gas(calldata) if ok else 0
        print(f"on-chain verify at 0x{contract.address.hex()}: "
              f"{'VALID' if ok else 'INVALID'} ({gas} gas incl. tx, "
              f"{transcript} transcript)")
        return 0 if ok else 1
    if args.check:
        from ..zk.yul import VMRevert, YulVM

        proof = files.read(files.et_proof())
        pub_inputs = files.read(files.et_public_inputs())
        calldata = zk.et_evm_calldata(pub_inputs, proof, shape=shape)
        try:
            out, gas = YulVM(code).run(calldata)
            ok = int.from_bytes(out, "big") == 1
        except VMRevert:
            ok, gas = False, 0
        print(f"EVM replay: {'VALID' if ok else 'INVALID'} "
              f"({gas} gas, {transcript} transcript)")
        return 0 if ok else 1


def handle_th_pk(args, files, config):
    """The reference's verb, with the dummy inner EigenTrust prove's
    rounds 3–4 on ``--device`` (settled first: a box without a card
    fails before any work)."""
    import os

    from ..zk import api as zk

    device = cli_device(args.device)
    # persist the dummy inner-ET snark next to the other artifacts so a
    # re-run of th-pk (or a th-proof after it) skips the duplicate
    # inner keygen/prove (zk/api.py inner-ET caches)
    os.environ.setdefault("PTPU_TH_CACHE_DIR", str(files.assets))
    params = files.read(files.kzg_params(TH_PARAMS_K))
    pk = zk.generate_th_pk(params, device=device)
    files.th_proving_key().write_bytes(pk)
    print(f"wrote {files.th_proving_key()}")


def handle_th_proof(args, files, config):
    """The reference's verb, with both proves (the inner EigenTrust
    snark and the Threshold circuit) on ``--device``, settled first."""
    from ..zk import api as zk

    device = cli_device(args.device)
    client = _make_client(files, config, device=device)
    atts = _load_attestations(files)
    setup = client.th_circuit_setup(
        atts, _parse_address(args.peer), args.threshold
    )
    params = files.read(files.kzg_params(TH_PARAMS_K))
    pk = files.read(files.th_proving_key())
    proof = zk.generate_th_proof(params, pk, setup, device=device)
    files.th_proof().write_bytes(proof)
    files.th_public_inputs().write_bytes(setup.pub_inputs.to_bytes())
    print(f"wrote {files.th_proof()} and {files.th_public_inputs()}")


def handle_th_verify(args, files, config):
    from ..zk import api as zk

    params = files.read(files.kzg_params(TH_PARAMS_K))
    pk = files.read(files.th_proving_key())
    proof = files.read(files.th_proof())
    pub_inputs = files.read(files.th_public_inputs())
    ok = zk.verify_th(params, pk, pub_inputs, proof)
    print("Threshold proof: VALID" if ok else "Threshold proof: INVALID")
    return 0 if ok else 1


def handle_serve(args, files, config):
    """Boot the long-running service (``service``) against the
    configured chain and block until SIGTERM/SIGINT drains it. The
    device is settled first: without a card and without ``--device
    cpu`` the verb fails before it binds a port or touches the state
    dir."""
    device = cli_device(args.device)

    from ..service import ServiceConfig, TrustService

    svc_config = ServiceConfig.from_env(
        host=args.host, port=args.port,
        poll_interval=args.poll_interval, tol=args.tol,
        max_iterations=args.max_iterations,
        queue_capacity=args.queue_capacity,
        pool_workers=args.workers,
        shard_proves=args.shard_proves,
        fabric=args.fabric, fabric_lease_ttl=args.fabric_lease_ttl,
        proof_shape=args.shape, transcript=args.transcript,
        state_dir=args.state_dir, follow=args.follow)
    if svc_config.state_dir:
        state_dir = Path(svc_config.state_dir)
        if not state_dir.is_absolute():
            state_dir = files.assets / state_dir
    else:
        state_dir = files.service_state_dir()
    if svc_config.follow:
        # follower replica: no chain client at all — the leader's
        # shipped WAL is the only upstream. The domain comes from the
        # same config the leader reads, so records decode identically.
        from ..service.follower import FollowerService

        domain = bytes.fromhex(config.domain.removeprefix("0x"))
        follower = FollowerService(
            svc_config.follow, domain, svc_config, str(state_dir),
            batched_ingest=None, device=device)
        url = follower.start()
        follower.install_signal_handlers()
        print(f"trust-scores FOLLOWER listening on {url} "
              f"(leader: {svc_config.follow}, state: {state_dir}, "
              f"peers: {follower.graph.n}, device: {device}); "
              "SIGTERM drains", flush=True)
        follower.wait()
        if follower.drain_clean:
            print("follower drained", flush=True)
            return 0
        print("follower drained UNCLEAN (timeout or persist failure)",
              flush=True)
        return 1
    if args.checkpoint_dir:
        ck_dir = Path(args.checkpoint_dir)
        if not ck_dir.is_absolute():
            ck_dir = files.assets / ck_dir
    else:
        # always under the state dir (a cursor without the WAL that
        # holds its pre-cursor attestations must not be resumed)
        ck_dir = state_dir / "cursor"
    # batched_ingest=None → the Client's auto rule (batched signer
    # recovery on the card from 32 lanes up); the batch verbs' False
    # default would pin the daemon to scalar recovery forever
    client = _make_client(files, config, batched_ingest=None,
                          device=device)
    if config.node_url == "memory":
        # tail the file-persisted local chain so attest runs from OTHER
        # processes are visible (the in-memory LocalChain a fresh Client
        # builds would be a frozen snapshot)
        from ..service.tailer import FileBackedLocalChain

        client.chain = FileBackedLocalChain(files.chain_json())
    service = TrustService(client, svc_config, str(ck_dir), files=files,
                           state_dir=str(state_dir))
    url = service.start()
    service.install_signal_handlers()
    replayed = service.store.replayed_records if service.store else 0
    print(f"trust-scores service listening on {url} "
          f"(chain: {config.node_url}, cursor: {service.tailer.cursor}, "
          f"state: {state_dir}, replayed: {replayed}, device: {device}); "
          "SIGTERM drains", flush=True)
    service.wait()
    if service.drain_clean:
        print("service drained", flush=True)
        return 0
    # an overrun drain budget / cursor persist failure must surface to
    # the supervisor (systemd restart-on-failure)
    print("service drained UNCLEAN (timeout or persist failure)",
          flush=True)
    return 1


def handle_prove_worker(args, files, config):
    """Run one external fabric worker process (the worker half of
    ``serve --fabric``): poll, lease, execute, publish — until
    ``--max-units`` / ``--idle-exit`` / SIGINT/SIGTERM. Its executors
    are host work on the prover core: no device to settle."""
    import functools
    import os
    import signal
    import threading

    from ..service.telemetry import TelemetryPusher, set_build_info
    from ..service.watchdog import Heartbeats, StallWatchdog
    from ..utils import trace
    from ..zk.fabric import FabricStore, RemoteFabric, run_worker

    name = args.name or f"fw{os.getpid()}"
    if args.url:
        fabric = RemoteFabric(args.url)
        fabric.lease_ttl = args.lease_ttl
        where = args.url
    else:
        if args.state_dir:
            state_dir = Path(args.state_dir)
            if not state_dir.is_absolute():
                state_dir = files.assets / state_dir
        else:
            state_dir = files.service_state_dir()
        from ..service.faults import FaultInjector

        root = Path(state_dir) / "fabric"
        # env-gated fault injection (PTPU_FAULT_DISK): a fault test can
        # tear THIS process's result writes; with the env unset it costs
        # nothing
        fabric = FabricStore(str(root), lease_ttl=args.lease_ttl,
                             faults=FaultInjector())
        where = str(root)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except (ValueError, OSError):  # non-main thread / platform
            pass
    # fleet observability: every span/event carries instance/role,
    # ptpu_build_info is up from the first scrape, and a telemetry
    # pusher ships the instrument state + recent span window to the
    # leader (HTTP in --url mode, atomic file drop under
    # <state-dir>/fabric/telemetry otherwise — the leader's observer
    # thread sweeps the drop dir)
    if not trace.TRACER.enabled:
        trace.enable()  # in-memory: telemetry needs the instruments
    set_build_info(name, "prove-worker")
    telemetry_interval = float(
        os.environ.get("PTPU_SERVE_TELEMETRY_INTERVAL", "2.0") or 2.0)
    target = args.url if args.url else str(Path(where) / "telemetry")
    pusher = TelemetryPusher(
        target, name, "prove-worker", interval=telemetry_interval,
        summary=lambda: {"polling": where,
                         "lease_ttl": args.lease_ttl})
    threading.Thread(target=pusher.run, args=(stop,), daemon=True,
                     name="ptpu-telemetry").start()
    # stall watchdog (no incident store — the worker's gauges ship to
    # the leader via telemetry, where the fleet-wide SLO path pages):
    # the worker loop heartbeats, a wedged native call ages it out
    beats = Heartbeats()
    loop_name = f"ptpu-worker-{name}"
    beats.register(loop_name)
    watchdog = StallWatchdog(
        beats,
        stall_after=float(os.environ.get(
            "PTPU_SERVE_WATCHDOG_STALL_AFTER", "30") or 30))
    watchdog.start()
    print(f"prove-worker {name} polling {where} "
          f"(lease ttl {args.lease_ttl:g}s)", flush=True)
    executed = run_worker(fabric, name, poll=args.poll,
                          lease_ttl=args.lease_ttl,
                          max_units=args.max_units,
                          idle_exit=args.idle_exit, stop=stop,
                          beat=functools.partial(beats.beat, loop_name))
    stop.set()
    watchdog.stop()
    # one farewell push so the final units' spans/instruments ship
    # even on a quick exit (best-effort, like every push)
    pusher.push_once()
    print(f"prove-worker {name} exiting after {executed} units",
          flush=True)
    return 0


def handle_obs(args, files, config):
    """Offline observability: parse + validate a JSONL trace stream
    (the ``PROTOCOL_TPU_TRACE`` / ``serve`` daemon output), render the
    span-aggregate summary table, optionally follow the stream or print
    one trace id's end-to-end chain. Exit 1 when invalid records were
    seen — the stream is a machine-readable contract, not best-effort
    logging."""
    import time as _time
    from collections import deque

    from ..utils.trace import validate_record

    def parse(line, lineno, invalid):
        line = line.strip()
        if not line:
            return None
        try:
            obj = json.loads(line)
        except ValueError:
            invalid.append(f"line {lineno}: not JSON")
            return None
        err = validate_record(obj)
        if err is not None:
            invalid.append(f"line {lineno}: {err}")
            return None
        return obj

    def matches(obj, trace_id):
        return (obj.get("trace_id") == trace_id
                or trace_id in (obj.get("trace_ids") or ()))

    invalid: list = []
    agg: dict = {}
    durations: dict = {}  # per-stage duration samples for p50/p95
    counts = {"span": 0, "event": 0, "metric": 0}
    chain: list = []

    def ingest(obj) -> None:
        counts[obj["type"]] += 1
        if obj["type"] == "span":
            a = agg.setdefault(obj["name"],
                               {"count": 0, "total_s": 0.0,
                                "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += obj["duration_s"]
            a["max_s"] = max(a["max_s"], obj["duration_s"])
            # bounded per-name sample window for the percentile
            # columns (a daemon stream can hold millions of spans;
            # deque(maxlen) keeps the append O(1))
            if obj["name"] not in durations:
                durations[obj["name"]] = deque(maxlen=16384)
            durations[obj["name"]].append(obj["duration_s"])
        if args.trace_id and matches(obj, args.trace_id):
            chain.append(obj)

    # size-rotation awareness (PTPU_TRACE_MAX_BYTES): a stream's `.1`
    # sibling holds the OLDER records — fold it in first so aggregates
    # cover the whole history and chains stay whole across a rotation
    import os as _os

    def _with_rotated(path: str) -> list:
        sib = path + ".1"
        return [sib, path] if _os.path.exists(sib) else [path]

    # merged streams (--jsonl, repeatable): other processes' trace
    # files fold into the same aggregate + chain view — the
    # cross-process trace join (worker spans carry instance/role);
    # the main stream's rotated sibling rides this loop too
    extra_streams = [p for e in args.extra_jsonl
                     for p in _with_rotated(e)]
    extra_streams += _with_rotated(args.path)[:-1]
    for extra in extra_streams:
        try:
            ef = open(extra)
        except OSError as e:
            raise EigenError("file_io_error",
                             f"cannot open trace stream: {e}") from e
        with ef:
            e_lineno = 0
            for line in ef:
                e_lineno += 1
                before = len(invalid)
                obj = parse(line, e_lineno, invalid)
                if obj is None:
                    if len(invalid) > before:
                        invalid[-1] = f"{extra} {invalid[-1]}"
                    continue
                ingest(obj)
    try:
        f = open(args.path)
    except OSError as e:
        raise EigenError("file_io_error",
                         f"cannot open trace stream: {e}") from e
    with f:
        lineno = 0
        for line in f:
            lineno += 1
            obj = parse(line, lineno, invalid)
            if obj is None:
                continue
            ingest(obj)

        shown = ", ".join([args.path, *args.extra_jsonl])
        print(f"{shown}: {counts['span']} span(s), "
              f"{counts['event']} event(s), {counts['metric']} "
              f"metric(s), {len(invalid)} invalid record(s)")
        for msg in invalid[:20]:
            print(f"  invalid: {msg}", file=sys.stderr)
        if agg:
            from ..utils.trace import percentile

            width = max(len(n) for n in agg)
            print(f"{'span':<{width}}  {'n':>8}  {'total_s':>10}  "
                  f"{'mean_ms':>9}  {'p50_ms':>9}  {'p95_ms':>9}  "
                  f"{'max_s':>9}")
            for name, a in sorted(agg.items(),
                                  key=lambda kv: -kv[1]["total_s"]):
                mean_ms = 1000.0 * a["total_s"] / a["count"]
                # agg and durations are filled in lockstep in the span
                # branch above, so the window is always present
                d = durations[name]
                p50_ms = 1000.0 * percentile(d, 0.50)
                p95_ms = 1000.0 * percentile(d, 0.95)
                print(f"{name:<{width}}  {a['count']:>8}  "
                      f"{a['total_s']:>10.3f}  {mean_ms:>9.3f}  "
                      f"{p50_ms:>9.3f}  {p95_ms:>9.3f}  "
                      f"{a['max_s']:>9.3f}")
        if args.trace_id:
            print(f"\ntrace {args.trace_id}: {len(chain)} record(s)")
            for obj in sorted(chain, key=lambda o: o.get("ts", 0.0)):
                dur = (f" {obj['duration_s'] * 1000:.3f}ms"
                       if obj["type"] == "span" else "")
                ids = ""
                if obj["type"] == "span":
                    ids = (f" span={obj.get('span_id', '?')}"
                           + (f" parent={obj['parent_id']}"
                              if obj.get("parent_id") else ""))
                # pool-worker attribution: which worker executed a
                # proof job's prover stages
                who = (f" worker={obj['worker']}"
                       if obj.get("worker") else "")
                # fleet attribution: which PROCESS emitted the record
                # (merged streams / shipped span windows carry it)
                inst = (f" instance={obj['instance']}"
                        if obj.get("instance") else "")
                rem = " remote=1" if obj.get("remote") else ""
                print(f"  {obj.get('ts', 0.0):.6f} {obj['type']:<6} "
                      f"{obj['name']}{dur}{ids}{who}{inst}{rem}")

        if args.follow:
            print("following (Ctrl-C to stop)...", file=sys.stderr)
            try:
                while True:
                    line = f.readline()
                    if not line:
                        _time.sleep(0.2)
                        continue
                    lineno += 1
                    if not line.strip():
                        continue  # blank: skipped, not invalid
                    before = len(invalid)
                    obj = parse(line, lineno, invalid)
                    if obj is None:
                        if len(invalid) > before:
                            print(f"  invalid: {invalid[-1]}",
                                  file=sys.stderr)
                        continue
                    if args.trace_id and not matches(obj, args.trace_id):
                        continue
                    print(json.dumps(obj), flush=True)
            except KeyboardInterrupt:
                pass
    return 1 if invalid else 0


def handle_store(args, files, config):
    """Offline maintenance of the serve daemon's state store: a
    human-readable summary (``inspect``) and latest-wins WAL compaction
    (``compact`` — duplicates folded by recovered (signer, about) key,
    the chain store's own identity)."""
    from pathlib import Path

    from ..store import AttestationWAL, ProofArtifactStore

    if args.state_dir:
        state_dir = Path(args.state_dir)
        if not state_dir.is_absolute():
            state_dir = files.assets / state_dir
    else:
        state_dir = files.service_state_dir()
    wal_dir = str(state_dir / "wal")

    if args.action == "inspect":
        # inspection must not mutate — and must be safe against a LIVE
        # daemon: readonly WAL scan, sweep-free snapshot listing, and
        # no directory creation anywhere
        from ..store.snapshot import list_steps_readonly, read_meta_readonly

        wal = AttestationWAL(wal_dir, readonly=True)
        records = sum(1 for _ in wal.replay())
        stats = wal.stats()
        print(f"state dir: {state_dir}")
        print(f"wal: {stats['segments']} segment(s), {stats['bytes']} "
              f"bytes, {records} intact record(s), "
              f"{stats['torn_skipped']} torn/corrupt scan stop(s)")
        snap_dir = str(state_dir / "snapshots")
        steps = list_steps_readonly(snap_dir)
        if steps:
            meta = read_meta_readonly(snap_dir, steps[-1]) or {}
            print(f"snapshots: {len(steps)} (latest revision "
                  f"{meta.get('revision')}, "
                  f"{meta.get('n_attestations')} attestation(s), "
                  f"wal position {meta.get('wal_segment')}:"
                  f"{meta.get('wal_offset')})")
        else:
            print("snapshots: none")
        # a CLI-launched daemon persists artifacts into the EigenFile
        # assets layout (handle_serve passes files=); state_dir/proofs
        # is the embedded/provers-injected fallback — report whichever
        # actually exists
        proofs_dir = files.proofs_dir()
        if not proofs_dir.is_dir():
            proofs_dir = state_dir / "proofs"
        n_proofs = (ProofArtifactStore(str(proofs_dir)).count()
                    if proofs_dir.is_dir() else 0)
        print(f"proof artifacts: {n_proofs} ({proofs_dir})")
        return 0

    # compact: fold by the chain store's identity — (creator, about) —
    # recovering each record's signer the way replay would; records that
    # fail recovery are dropped (replay rejects them anyway)
    from ..client.attestation import DOMAIN_PREFIX, SignedAttestationData
    from ..client.eth import address_from_public_key

    domain = bytes.fromhex(config.domain.removeprefix("0x"))
    key = DOMAIN_PREFIX + domain

    def fold_key(block, about, payload):
        try:
            signed = SignedAttestationData.from_log(about, key, payload)
            signer = address_from_public_key(signed.recover_public_key())
        except (EigenError, ValueError):
            return None
        return signer, about

    from ..store.state_store import acquire_state_lock

    lock = acquire_state_lock(str(state_dir))  # refuse a live daemon
    try:
        wal = AttestationWAL(wal_dir)
        out = wal.compact(fold_key)
        wal.close()
    finally:
        if lock is not None:
            lock.close()
    print(f"compacted: {out['records_in']} record(s) -> "
          f"{out['records_out']} in segment {out['segment']} "
          f"({out['dropped']} unrecoverable dropped, "
          f"{out['segments_removed']} old segment(s) removed)")
    return 0


def _fetch_json(url: str, path: str, timeout: float = 10.0):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url.rstrip("/") + path,
                                    timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError) as e:
        raise EigenError("network_error",
                         f"cannot fetch {path} from {url}: {e}") from e


def _fmt_cell(value, unit: str = "") -> str:
    if value is None:
        return "-"  # no data (pre-publish sentinel): honest, not -1
    if isinstance(value, float):
        return f"{value:.2f}{unit}"
    return f"{value}{unit}"


def handle_fleet(args, files, config):
    """Render a leader's /fleet registry as an operator table: one
    row per known instance, dead ones flagged, never dropped."""
    fleet = _fetch_json(args.url, "/fleet")
    if args.json:
        print(json.dumps(fleet, indent=2))
        return 0
    rows = fleet.get("instances", [])
    counts = fleet.get("counts", {})
    print(f"fleet @ {args.url}: {counts.get('active', 0)}/"
          f"{counts.get('total', 0)} active "
          f"(ttl {fleet.get('ttl_seconds', 0):g}s) "
          f"roles={counts.get('by_role', {})}")
    width = max([len(r.get("instance", "")) for r in rows] + [8])
    print(f"{'instance':<{width}}  {'role':<12} {'up':<4} "
          f"{'report_age':>10}  {'freshness':>9}  {'repl_lag':>8}")
    for r in rows:
        print(f"{r.get('instance', '?'):<{width}}  "
              f"{r.get('role', '?'):<12} "
              f"{'up' if r.get('active') else 'DEAD':<4} "
              f"{_fmt_cell(r.get('report_age_seconds'), 's'):>10}  "
              f"{_fmt_cell(r.get('score_freshness_seconds'), 's'):>9}  "
              f"{_fmt_cell(r.get('repl_lag_seconds'), 's'):>8}")
    return 0


def handle_slo(args, files, config):
    """Render a daemon's /slo evaluation; exit 1 while any alert is
    latched (scriptable: the smoke and a pager check share it)."""
    slo = _fetch_json(args.url, "/slo")
    if args.json:
        print(json.dumps(slo, indent=2))
        return 1 if slo.get("alerting") else 0
    rows = slo.get("slos", [])
    print(f"slo @ {args.url}: {len(rows)} objective(s), "
          f"alerts={slo.get('alerts', [])}")
    if rows:
        width = max(len(r.get("slo", "")) for r in rows)
        print(f"{'slo':<{width}}  {'objective':>9}  {'fast_burn':>9}  "
              f"{'slow_burn':>9}  {'budget':<10} {'alert':<5}")
        for r in rows:
            burn = r.get("burn", {})
            print(f"{r.get('slo', '?'):<{width}}  "
                  f"{r.get('objective', 0.0):>9.3f}  "
                  f"{burn.get('fast', 0.0):>9.3f}  "
                  f"{burn.get('slow', 0.0):>9.3f}  "
                  f"{'in-budget' if r.get('in_budget') else 'BURNING':<10} "
                  f"{'YES' if r.get('alerting') else 'no':<5}")
    return 1 if slo.get("alerting") else 0


def handle_incident(args, files, config):
    """List a daemon's incident bundles, or render one as the
    human-readable autopsy (``service/recorder.py::render_autopsy``)."""
    import time

    if args.id is None:
        index = _fetch_json(args.url, "/incidents")
        if args.json:
            print(json.dumps(index, indent=2))
            return 0
        rows = index.get("incidents", [])
        print(f"incidents @ {args.url}: {len(rows)} bundle(s)")
        for r in rows:
            ts = r.get("captured_at")
            when = (time.strftime("%Y-%m-%d %H:%M:%S",
                                  time.localtime(ts)) if ts else "?")
            print(f"  {r.get('id', '?')}  {when}  "
                  f"[{r.get('trigger', '?')}] {r.get('reason', '')}")
        return 0
    inc_id = args.id
    if inc_id == "latest":
        rows = _fetch_json(args.url, "/incidents").get("incidents", [])
        if not rows:
            print("no incidents captured", file=sys.stderr)
            return 1
        inc_id = rows[-1]["id"]
    bundle = _fetch_json(args.url, f"/incidents/{inc_id}")
    if args.json:
        print(json.dumps(bundle, indent=2))
        return 0
    from ..service.recorder import render_autopsy

    print(render_autopsy(bundle), end="")
    return 0


def handle_scenario(args, files, config):
    from .scenariocmd import handle_scenario as _handle

    return _handle(args, files, config)


def handle_profile(args, files, config):
    from .profilecmd import handle_profile as _handle

    if args.workload in ("prove", "refresh"):
        cli_device(args.device)  # no card and no --device: fail first
    try:
        return _handle(args)
    except RuntimeError as e:  # no GPU and no --device
        raise CliError(str(e)) from e


HANDLERS = {
    "attest": handle_attest,
    "attestations": handle_attestations,
    "bandada": handle_bandada,
    "deploy": handle_deploy,
    "et-proof": handle_et_proof,
    "et-proving-key": handle_et_pk,
    "et-verifier": handle_et_verifier,
    "et-verify": handle_et_verify,
    "fleet": handle_fleet,
    "incident": handle_incident,
    "kzg-params": handle_kzg_params,
    "local-scores": lambda a, f, c: handle_scores(a, f, c, local=True),
    "obs": handle_obs,
    "profile": handle_profile,
    "prove-worker": handle_prove_worker,
    "scenario": handle_scenario,
    "scores": lambda a, f, c: handle_scores(a, f, c, local=False),
    "serve": handle_serve,
    "show": handle_show,
    "slo": handle_slo,
    "sparse-scores": handle_sparse_scores,
    "store": handle_store,
    "th-proof": handle_th_proof,
    "th-proving-key": handle_th_pk,
    "th-verify": handle_th_verify,
    "update": handle_update,
}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        files = config = None
        # the verbs that read no assets
        if args.command not in ("profile", "obs", "fleet", "slo",
                                "incident"):
            files = EigenFile(assets_dir(args.assets))
            config = _load_config(files)
        return HANDLERS[args.command](args, files, config) or 0
    except (CliError, EigenError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
