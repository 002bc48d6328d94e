"""Service configuration: one dataclass, env-overridable.

The batch CLI keeps its knobs in ``ClientConfig`` + flags; the daemon
adds serving-specific ones (poll cadence, refresh tolerances, staleness
bounds, queue sizes, drain budget). Every field has a ``PTPU_SERVE_*``
env override so a supervisor (systemd/k8s) can tune a deployment
without editing code; CLI flags (``serve`` verb) win over env.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields

from ..utils.errors import EigenError


@dataclass
class ServiceConfig:
    # --- HTTP -------------------------------------------------------------
    host: str = "127.0.0.1"
    port: int = 8799  # 0 = ephemeral (the bound port is logged/returned)

    # --- chain tailer -----------------------------------------------------
    poll_interval: float = 1.0      # seconds between get_logs polls
    backoff_base: float = 0.5       # first retry delay after an RPC fault
    backoff_max: float = 30.0       # exponential backoff cap
    cursor_keep: int = 3            # block-cursor checkpoints retained

    # --- score refresh ----------------------------------------------------
    refresh_interval: float = 0.5   # max latency from ingest to refresh
    # relative-L1 stopping tolerance. The device sublinear rungs run
    # in the backend's dtype (float32 by default), whose residual
    # floors near 1e-6 at scale: a finer tol there stops at the floor
    # with the slack charged against refresh_error_budget (or, in
    # exact mode, declines to the f64 host/full rungs).
    tol: float = 1e-9
    max_iterations: int = 500
    initial_score: float = 1000.0
    alpha: float = 0.0              # pre-trust damping (0 = reference)
    # staleness bound for the warm start: past either, refresh runs COLD
    # (uniform start) — warm starting assumes the previous fixed point
    # is near the new one, which stops holding when a large slice of
    # the opinion matrix changed (PAPERS.md, arXiv 2606.11956)
    cold_edit_fraction: float = 0.5  # edits since last cold / edge count
    cold_every: int = 64             # periodic cold resync regardless
    # past this many edges the refresh routes through TorchRoutedBackend
    # with a digest-keyed compiled-operator cache (memory + on-disk
    # under <state-dir>/operators) instead of rebuilding the ELL
    # operator per refresh; 0 disables the routed path entirely
    routed_edge_threshold: int = 100_000

    # --- incremental delta engine (``incremental``) -----------------------
    # 1 (default): once the routed path has built an operator, edge
    # churn is absorbed by delta-patching it in place — weight
    # revisions patch the value buffers, structural inserts ride a
    # bounded COO overflow tail, dirty rows re-normalize through
    # inv_row_scale — and full routing-plan rebuilds become a rare,
    # amortized event. 0 restores rebuild-per-digest-change.
    delta_updates: int = 1
    # overflow-tail budget: a full rebuild is scheduled when the tail
    # exceeds delta_tail_max entries or delta_tail_fraction of the
    # anchored edge count, whichever is smaller
    delta_tail_max: int = 65_536
    delta_tail_fraction: float = 0.25
    # partial refresh: warm sweeps restricted to the dirty frontier +
    # fan-in; past this fraction of the peer set the frontier is no
    # longer "partial" and the refresh degrades down the ladder
    # (sampled, then a full — still rebuild-free — device sweep).
    # 0 disables the partial/sampled rungs entirely.
    partial_frontier_fraction: float = 0.25
    # the sublinear-refresh ladder (partial -> device_partial ->
    # sampled -> full -> rebuild): frontiers at/above this many rows
    # run the partial sweeps through the device segment-gather kernel
    # (ops.converge.partial_sweep_device) instead of host numpy — the
    # host path wins below it on interpreter-dispatch grounds. 0 =
    # always device, negative = host sweeps only.
    device_partial_threshold: int = 4096
    # partially-observed mode: when the frontier outgrows the partial
    # bound, converge on frontier + importance-sampled fan-out closure
    # up to this many rows, with the neglected-propagation mass
    # accumulated against the L1 honesty budget. 0 disables the rung.
    sample_budget: int = 1 << 20
    # the declared relative-L1 error budget of the sublinear rungs: on
    # small-world graphs the EXACT influence region of any churn
    # floods the whole graph at tol-level thresholds, so sublinearity
    # is bought with a declared, accounted approximation — every rung
    # charges its neglected-propagation mass (|Δ|·external-out-weight)
    # against this budget and falls back to the full sweep when it is
    # genuinely exhausted; the per-refresh spend is live on
    # ptpu_refresh_budget_spent. The periodic cold resync
    # (cold_every) re-anchors exactness. 0 = exact mode (budget =
    # tol): sublinear rungs serve only churn whose influence truly
    # stays local.
    refresh_error_budget: float = 1e-3

    # --- durable state store ----------------------------------------------
    # empty = memory-only (the block cursor is still checkpointed);
    # set (or pass serve --state-dir) to make restarts lossless:
    # attestation WAL + graph snapshots + persisted proof artifacts
    state_dir: str = ""
    wal_segment_bytes: int = 4 << 20  # WAL segment rotation size
    wal_fsync: str = "always"       # "always": fsync per appended batch;
                                    # "never": leave it to the OS (faster,
                                    # loses the page-cache tail on power cut)
    snapshot_every: int = 256       # graph edits between snapshots
    snapshot_keep: int = 2          # snapshots retained (older pruned)
    # format-2 snapshots make the WAL the attestation history (it is no
    # longer pruned on snapshot): once it holds at least this many
    # segments, the daemon folds latest-wins duplicates per recovered
    # (signer, about) into a fresh segment — at startup before
    # restoring AND from the periodic snapshot cadence, so a
    # long-lived daemon's log stays bounded too. The daemon-side twin
    # of the offline `store compact` verb. 0 disables auto-compaction.
    wal_compact_segments: int = 8

    # --- read-path replication ------------------------------------
    # follower mode: set to a leader's base URL (serve --follow) and
    # the daemon boots as a READ REPLICA — restore from the leader's
    # snapshot, tail its shipped WAL (/repl/wal), apply edges through
    # the same OpinionGraph/refresh ladder, serve /scores //score/<addr>
    # //healthz //metrics //bundle hermetically. No chain tailer, no
    # proof pool: POST /proofs answers 503 read-only.
    follow: str = ""
    # stable follower identity reported to the leader (the shipping
    # floor + /status repl rows key on it); "" derives one from the
    # state dir so a restarted follower keeps its row
    follower_id: str = ""
    # max shipped bytes per /repl/wal fetch (whole frames; one
    # oversized record still ships alone)
    repl_max_bytes: int = 1 << 20
    # leader side: followers seen within this window are ACTIVE — WAL
    # compaction defers while an active follower is catching up (the
    # ship floor); beyond it a dead replica stops pinning the log and
    # re-tails the folded history (content-dedup-safe) when it returns
    repl_follower_ttl: float = 120.0

    # --- proof pool -------------------------------------------------------
    # workers: 0 = one per CUDA device (host-path workers on a CPU box
    # give 1); an explicit count forces that many workers, pinned
    # round-robin across devices
    pool_workers: int = 0
    queue_capacity: int = 8         # legacy depth knob; the tiered
    # admission watermark defaults to it (shed_watermark=0)
    # tiered load shedding: below the watermark every kind queues;
    # above it the admission floor rises one priority tier per extra
    # watermark of depth (profile < threshold < eigentrust,
    # provers.PROOF_PRIORITIES) — shed kinds get 429 + Retry-After.
    # Only the byte budget of queued job params is a hard 503.
    shed_watermark: int = 0         # 0 = queue_capacity
    queue_bytes: int = 4 << 20      # hard-503 ceiling on queued params
    proof_shape: str = "default"    # "default" (k=21 SRS) | "tiny" (k=20)
    transcript: str = "keccak"
    # intra-prove sharding (opt-in): 1 = a prove submitted to the pool
    # fans its independent work units (commit columns per engine
    # flush, host quotient row chunks, the two opening folds) out to
    # IDLE pool workers, with a deterministic merge point that keeps
    # proofs byte-identical to a direct single-worker prove_fast
    # (profile jobs are exempt — a capture window has no shardable
    # stages). 0 (default): every prove runs entirely on its own
    # worker (the single-worker behavior).
    shard_proves: int = 0
    # fan-out cap per sharded stage; the effective fan-out is
    # min(shard_cap, pool workers + live fabric workers), so 1
    # disables splitting even with shard_proves=1
    shard_cap: int = 4
    # cross-process proving fabric (opt-in, needs a state dir): 1 =
    # sharded proves ALSO publish their units under
    # <state-dir>/fabric/ so external `prove-worker` processes (same
    # box via the filesystem, other boxes via the /fabric HTTP
    # surface) lend silicon into one prove. In-process lending keeps
    # priority; with no external worker registered the fabric costs
    # nothing per prove.
    fabric: int = 0
    # seconds an external worker's unit lease (and its registration
    # heartbeat window) lives without renewal before the unit is
    # reclaimable — the bound on how long a rendezvous waits on a
    # SIGKILLed worker
    fabric_lease_ttl: float = 5.0

    # --- fleet observability --------------------------------------
    # stable fleet identity stamped on every trace record and telemetry
    # report; "" derives one from the role + state dir (leader) or
    # follower_id (follower) so a restart keeps its /fleet row
    instance_id: str = ""
    # non-leader processes push a telemetry snapshot (instrument state
    # + recent span window) to the leader this often
    telemetry_interval: float = 2.0
    # leader side: an instance whose last report is older than this is
    # rendered inactive on /fleet (staleness-honest: the row stays)
    telemetry_ttl: float = 30.0
    # SLO burn-rate engine cadence and its fast/slow windows (the
    # multi-window AND-gate: both must burn >1x before an alert trips)
    slo_interval: float = 5.0
    slo_fast_window: float = 60.0
    slo_slow_window: float = 300.0

    # --- incident flight recorder ------------------------------
    # bounded in-memory ring of notable moments (SLO transitions,
    # stall dumps, compile events) frozen into every capture
    incident_ring_cap: int = 2048
    # bundles retained under <state-dir>/incidents (oldest evicted)
    incident_retention: int = 16
    # minimum seconds between automatic captures — a flapping SLO must
    # not write bundles in a loop; operator POSTs bypass with force
    incident_min_interval: float = 30.0
    # stall watchdog: evaluation cadence and the heartbeat age past
    # which a service thread is declared stalled (stack dumped into
    # the ring + incident capture + ptpu_thread_stalled=1). Keep the
    # stall threshold aligned with the thread_stall SLO threshold.
    watchdog_interval: float = 1.0
    watchdog_stall_after: float = 30.0
    # test/smoke-only: 1 exposes POST /debug/fail (always answers 500)
    # so an error-rate SLO burn can be forced on a live daemon
    debug_faults: int = 0

    # --- lifecycle --------------------------------------------------------
    drain_timeout: float = 30.0     # SIGTERM: budget to finish in-flight

    @classmethod
    def from_env(cls, **overrides) -> "ServiceConfig":
        """Env-resolved config: ``PTPU_SERVE_<FIELD>`` per field, then
        explicit ``overrides`` (CLI flags) on top. Unknown override
        keys are rejected — a typo'd flag must not silently no-op."""
        values = {}
        for f in fields(cls):
            env = os.environ.get(f"PTPU_SERVE_{f.name.upper()}")
            if env is None:
                continue
            try:
                if f.type == "float":
                    values[f.name] = float(env)
                elif f.type == "int":
                    values[f.name] = int(env)
                else:
                    values[f.name] = env
            except ValueError as e:
                raise EigenError(
                    "config_error",
                    f"bad PTPU_SERVE_{f.name.upper()}={env!r}: {e}") from e
        for k, v in overrides.items():
            if k not in cls.__dataclass_fields__:
                raise EigenError("config_error",
                                 f"unknown service config field {k!r}")
            if v is not None:
                values[k] = v
        return cls(**values)
