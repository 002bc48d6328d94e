"""Fault-tolerant sharded convergence: chunked iteration with checkpoint
/ resume, the counterpart of ``protocol_tpu/parallel/checkpointed.py``.

At 10M peers a preempted job must restart from the last completed
chunk. This loop runs the adaptive sharded power iteration in chunks
of ``checkpoint_every`` iterations, persists the score vector after
each chunk (atomic ``CheckpointManager``), and resumes from the newest
checkpoint when one exists.

The convergence semantics are those of one uninterrupted
``sharded_converge_adaptive`` run: the power iteration is memoryless
(state = score vector), so chunking changes nothing but adds resume
points. The global L1-delta stopping predicate is evaluated inside each
chunk exactly as in the unchunked loop. The checkpoint files and their
metadata keys are the reference's, so a run checkpointed by one package
resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace
from ..utils.checkpoint import CheckpointManager
from .converge import _resolve_sharded, as_tensor, sharded_converge_adaptive
from .mesh import Mesh


def sharded_converge_checkpointed(
    sop,
    s0,
    mesh: Mesh,
    checkpoints: CheckpointManager,
    tol: float = 1e-6,
    max_iterations: int = 100,
    alpha: float = 0.0,
    checkpoint_every: int = 10,
    resume: bool = True,
):
    """Adaptive sharded convergence with periodic checkpoints.

    ``sop`` may be a gather-path ``ShardedOperator`` (optionally paired
    with placed arrays, see ``_resolve_sharded``) or a Clos-routed
    ``ShardedRoutedOperator``; the chunked loop and resume semantics
    are identical. ``s0`` is a torch tensor (its dtype is the run's).
    Returns (scores_padded, total_iterations, final_relative_delta).
    ``total_iterations`` counts work done across all runs including the
    iterations replayed from checkpoints on resume.
    """
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")

    from .routed import (
        ShardedRoutedOperator,
        place_sharded_routed,
        sharded_routed_converge_adaptive,
    )

    s0 = as_tensor(s0)
    dtype = s0.dtype
    if isinstance(sop, ShardedRoutedOperator):
        # Clos-routed sharded backend: state lives in the operator's
        # padded state order; the chunked loop is otherwise identical.
        # Stage/weight arrays are placed ONCE — they are gigabytes at
        # scale and must not be re-staged per chunk.
        meta = sop
        state_len = sop.n_state
        engine = "routed"
        placed = place_sharded_routed(sop, mesh, dtype, alpha)

        def run_chunk(scores, chunk):
            return sharded_routed_converge_adaptive(
                (sop, placed), scores, mesh, tol=tol, max_iterations=chunk,
                alpha=alpha, dtype=dtype)
    else:
        meta, arrs = _resolve_sharded(sop, mesh, dtype, alpha)
        state_len = meta.n_pad
        engine = "gather"

        def run_chunk(scores, chunk):
            return sharded_converge_adaptive(
                (meta, arrs), scores, mesh, tol=tol, max_iterations=chunk,
                alpha=alpha)

    done = 0
    delta = float("inf")
    if resume and checkpoints.latest() is not None:
        step, arrays, ck_meta = checkpoints.restore()
        if arrays["scores"].shape[0] != state_len:
            raise ValueError(
                f"checkpoint score length {arrays['scores'].shape[0]} does "
                f"not match the operator's state length {state_len}"
            )
        # a resume under a different configuration would silently blend
        # two trajectories; n/n_valid fingerprint the graph, alpha the
        # iteration semantics, engine the score-vector ORDER (gather =
        # node order, routed = permuted device-major state order — same
        # length does not mean same meaning). tol may legitimately
        # change — it only affects the stopping predicate of a
        # memoryless iteration.
        fingerprint = [("n", meta.n), ("n_valid", meta.n_valid),
                       ("alpha", float(alpha)), ("engine", engine)]
        if engine == "routed":
            # the routed state vector is a device-major permutation of the
            # node scores: its LAYOUT depends on the shard count and state
            # exponent even when the length 2^state_e happens to match
            fingerprint += [("num_shards", sop.num_shards),
                            ("state_e", sop.state_e)]
        for key, current in fingerprint:
            recorded = ck_meta.get(key)
            if key == "engine" and recorded is None:
                # checkpoints written before the engine key existed were
                # always gather (node-order scores)
                recorded = "gather"
            if recorded is None and key in ("num_shards", "state_e"):
                # a routed checkpoint without a layout fingerprint cannot
                # prove its device-major order matches this run — refuse
                # rather than risk resuming a scrambled vector
                raise ValueError(
                    f"routed checkpoint records no {key}; cannot verify its "
                    f"score layout matches this run — delete the checkpoint "
                    f"directory to restart"
                )
            if recorded is not None and recorded != current:
                raise ValueError(
                    f"checkpoint was written with {key}={recorded}, "
                    f"resume requested {key}={current}"
                )
        s0 = torch.from_numpy(np.asarray(arrays["scores"])).to(dtype)
        done = step
        # carry the recorded delta so a resume that has no iterations
        # left (or is already converged) reports the true final state
        delta = float(ck_meta.get("delta", float("inf")))
        trace.event("converge.resume", step=step, delta=delta)

    scores = s0
    with trace.span("converge.checkpointed", n=meta.n, tol=tol):
        while done < max_iterations and delta > tol:
            chunk = min(checkpoint_every, max_iterations - done)
            with trace.span("converge.chunk", start=done, size=chunk):
                scores, iters, delta = run_chunk(scores, chunk)
            done += iters
            trace.metric("converge.delta", delta)
            checkpoints.save(
                done,
                {"scores": scores.cpu().numpy()},
                meta={"delta": delta, "tol": tol, "alpha": float(alpha),
                      "n": meta.n, "n_pad": state_len,
                      "n_valid": meta.n_valid, "engine": engine,
                      "converged": delta <= tol,
                      **({"num_shards": sop.num_shards,
                          "state_e": sop.state_e}
                         if engine == "routed" else {})},
            )
            if iters < chunk:
                break  # stopping predicate fired inside the chunk
    return scores, done, delta


def run_with_retries(
    fn,
    max_restarts: int = 2,
    retryable: tuple = (RuntimeError,),
):
    """Tiny elastic-recovery harness: call ``fn()`` (typically a closure
    over :func:`sharded_converge_checkpointed` with ``resume=True``),
    restarting on device/runtime failures. Each retry resumes from the
    newest checkpoint — the recompute window is at most
    ``checkpoint_every`` iterations."""
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            attempt += 1
            trace.event("converge.restart", attempt=attempt, error=repr(e))
            if attempt > max_restarts:
                raise
