"""Batched multi-column commit engine for the PLONK provers.

The reference package found its device prove's remaining wall in the
commit path (its BASELINE.md r4, measured on its TPU host): every
column an independent ``native.g1_msm`` call that re-parses,
re-converts and re-streams the SAME base array (SRS or Lagrange
powers) window by window. This module, copied from it, is the
scheduler over the fix:

- **Batching**: commit columns are submitted as (label, bases, scalars)
  work items; columns over the same bases with the same length group
  into ONE ``native.g1_msm_multi`` call — base parse and Montgomery/
  w-domain conversion amortized across the K columns, with the kernel's
  bucket-range-tiled batch-affine levels and 32-chain vector bucket
  reduction doing the per-column heavy lifting (bit-exact per column vs
  K serial ``g1_msm`` calls; BENCH_r08 holds the speedup curve and the
  measured finding that sharing INSIDE one window pass is net-negative
  on this box — ``PN_MSM_KB`` re-enables it).
- **Download/commit overlap**: items may carry a ``fetch`` callable
  instead of materialized scalars (device→host chunk downloads, opening
  folds). ``flush()`` runs fetches on one background thread, in
  submission order, and greedily batches whatever columns are READY
  while the native MSM (which releases the GIL) chews the previous
  batch — the generic form of the one-off t-chunk downloader thread it
  replaces.
- **Ordering**: ``flush()`` returns points in SUBMISSION order and the
  caller absorbs them into the transcript there — points may be
  computed out of order but are absorbed in order, so proofs are
  byte-identical with the engine on or off (tested for both prove
  paths).
- **Device seam**: ``PTPU_MSM_DEVICE=1`` routes every column through
  ``ops.msm_device.msm_device``, the sorted-prefix device MSM, on the
  engine's ``msm_device`` (default: the card; raises without one). It
  is opt-in, as in the reference: the host's batched MSM stays the
  default.
- **Shards**: when a shard runner is installed (``zk/shards.py`` — the
  proof pool installs one around shardable jobs), each ready group's
  columns split into ≤ fan-out sub-batches dispatched as addressable
  shard units, so idle pool workers execute commit MSMs of a running
  prove. Points are still absorbed in submission order and every
  column is bit-exact regardless of grouping, so sharding never moves
  a transcript byte. ``flush_async()`` additionally dispatches the
  already-materialized groups NOW and returns a rendezvous handle —
  the shards compute under whatever device-occupancy window the
  caller holds before ``result()``.

Knobs: ``PTPU_COMMIT_ENGINE=0`` disables batching (serial per-column
oracle path, same scheduling surface); ``PTPU_MSM_DEVICE=1`` selects
the device seam; ``PN_MSM_C`` / the cached auto-tune (see
``native.apply_msm_tuning``) size the Pippenger window.

Observability: every batch records ``ptpu_commit_batch_size{bases}``
and the caller wraps each flush in a ``ptpu_prover_stage_seconds``
stage labelled ``stage="commit.*", batched="0|1"``.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from ..native import prover as native
from ..utils import trace
from ..utils.errors import EigenError
from ..utils.fields import BN254_FR_MODULUS
from .bn254 import BN254_FQ_MODULUS, g1_add, g1_mul

R = BN254_FR_MODULUS
Q = BN254_FQ_MODULUS

# columns per g1_msm_multi call: the native kernel sweeps column
# chunks internally for cache locality (PN_MSM_KB); 16 just bounds one
# call's scalar footprint
MAX_BATCH = 16

_R_LIMBS = np.frombuffer(int(R).to_bytes(32, "little"), dtype="<u8")
_HALF_LIMBS = np.frombuffer(((R + 1) // 2).to_bytes(32, "little"),
                            dtype="<u8")


def engine_enabled() -> bool:
    """Batched commits are on unless ``PTPU_COMMIT_ENGINE=0`` (or the
    native library is absent — the engine is a scheduler over native
    kernels; pure-Python proving never routes through it)."""
    if os.environ.get("PTPU_COMMIT_ENGINE", "1") == "0":
        return False
    return native.available()


def device_msm_enabled() -> bool:
    return os.environ.get("PTPU_MSM_DEVICE") == "1"


def balance_rows(flat: np.ndarray) -> np.ndarray:
    """IN-PLACE scalar balancing of an (m, 4) uint64 limb array: every
    row with s ≥ (R+1)/2 becomes R−s (lexicographic limb compare + a
    4-limb borrow subtract); returns the boolean flip mask. The ONE
    copy of this subtle limb arithmetic — the engine's column batches
    and ``prover_fast._msm_signed``'s per-call base negation both call
    it, so the serial oracle and the batched path can never drift."""
    m = len(flat)
    ge = np.zeros(m, dtype=bool)
    eq = np.ones(m, dtype=bool)
    for j in (3, 2, 1, 0):
        ge |= eq & (flat[:, j] > _HALF_LIMBS[j])
        eq &= flat[:, j] == _HALF_LIMBS[j]
    ge |= eq
    rows = np.nonzero(ge)[0]
    if len(rows):
        borrow = np.zeros(len(rows), dtype=np.uint64)
        for j in range(4):
            sub = flat[rows, j] + borrow
            wrapped = sub < borrow  # s_j + borrow overflowed 2^64
            diff = _R_LIMBS[j] - sub  # uint64 wrap IS the borrow case
            borrow = ((_R_LIMBS[j] < sub) | wrapped).astype(np.uint64)
            flat[rows, j] = diff
    return ge


def balance_columns(stack: np.ndarray) -> tuple:
    """Scalar-balancing for a (K, n, 4) column stack: every s ≥ (R+1)/2
    is replaced by R−s with the flip bit set, so a near-R scalar (−1,
    −small coefficients) costs one window pass instead of seventeen.
    OWNS (mutates) ``stack`` — callers pass a private copy; at k=21 a
    7-column batch is ~450 MB, and a defensive copy here would double
    the flush's transient footprint. Returns (stack, flips (K, n)
    uint8) — the shared-base twin of ``_msm_signed``'s per-call base
    negation: the flips ride into ``g1_msm_multi`` instead of K
    private negated copies of the base array."""
    kcols, n = stack.shape[0], stack.shape[1]
    ge = balance_rows(stack.reshape(kcols * n, 4).view(np.uint64))
    return stack, ge.reshape(kcols, n).astype(np.uint8)


class _Item:
    __slots__ = ("label", "bases_id", "scalars", "fetch", "blinds",
                 "point", "error")

    def __init__(self, label, bases_id, scalars, fetch, blinds):
        self.label = label
        self.bases_id = bases_id
        self.scalars = scalars
        self.fetch = fetch
        self.blinds = blinds
        self.point = None
        self.error = None


class CommitEngine:
    """Per-prove commit scheduler (see module docstring). Submit
    columns as they become ready; ``flush()`` computes every pending
    commit (batched + overlapped) and returns the points in submission
    order for in-order transcript absorption."""

    def __init__(self, params, msm_device=None):
        self.params = params
        self.batching = engine_enabled()
        self.device = device_msm_enabled()
        # the torch device of the device seam's MSMs, resolved at the
        # first one (None: the card)
        self.msm_device = msm_device
        self._device_pts: dict = {}
        self._items: list = []
        self._cv = threading.Condition()

    def stage_labels(self) -> dict:
        """The ``batched`` label dimension for commit.* stage series."""
        return {"batched": "1" if self.batching and not self.device
                else "0"}

    # --- submission --------------------------------------------------------

    def submit_evals(self, label: str, evals: np.ndarray | None = None,
                     blinds=(), fetch=None) -> None:
        """Commit a polynomial from its 2^k-domain EVALUATIONS via the
        Lagrange basis, plus the Z_H-blinding τ-basis correction —
        the batched form of ``prover_fast._commit_blinded_evals``."""
        if self.params.g1_lagrange is None:
            raise EigenError("proving_error",
                             "params carry no Lagrange basis")
        if evals is not None and len(evals) != (1 << self.params.k):
            raise EigenError("proving_error",
                             "evals length must equal 2^k")
        self._items.append(_Item(label, "lagrange", evals, fetch,
                                 list(blinds)))

    def submit_coeffs(self, label: str, coeffs: np.ndarray | None = None,
                      fetch=None) -> None:
        """Commit a coefficient array over the SRS powers — the batched
        form of ``prover_fast.commit_limbs``."""
        if coeffs is not None and len(coeffs) > len(self.params.g1_powers):
            raise EigenError("proving_error", "poly exceeds SRS")
        self._items.append(_Item(label, "srs", coeffs, fetch, []))

    # --- execution ---------------------------------------------------------

    def flush(self) -> list:
        """Compute every pending commit and return the points in
        submission order. Fetch-backed items download on ONE background
        thread in submission order; the main thread greedily groups
        whatever is ready into ``g1_msm_multi`` batches, so downloads
        overlap the GIL-released MSM compute. Under a shard runner each
        group additionally fans out to lent pool workers (points still
        land in submission order — see the module docstring)."""
        return self.flush_async().result()

    def flush_async(self) -> "FlushHandle":
        """The rendezvous form of :func:`flush`: pending commits whose
        scalars are already materialized are grouped and DISPATCHED as
        shard units immediately (when a runner is installed), then a
        handle is returned. ``result()`` completes whatever remains —
        fetch-backed items, unclaimed units — and returns the points in
        submission order. The caller can hold a device-occupancy window
        between dispatch and ``result()`` and the lent workers chew the
        MSMs under it; without a runner this degenerates to plain
        ``flush()`` work done inside ``result()``."""
        from . import shards

        items, self._items = self._items, []
        handle = FlushHandle(self, items)
        if not items:
            return handle
        fetches = [it for it in items if it.scalars is None]
        if fetches:
            # the fetch thread inherits the submitting thread's trace
            # context and pool-worker identity — fetch callables run
            # real traced work (fold downloads + divides), and a bare
            # thread would detach their spans from the job's trace
            ctx_ids = trace.current_trace_ids()
            worker = trace.current_worker()
            handle.fetch_thread = threading.Thread(
                target=self._fetch_loop,
                args=(fetches, ctx_ids, worker),
                daemon=True, name="commit-engine-fetch")
            handle.fetch_thread.start()
        runner = shards.current_runner()
        if runner is not None and not self.device:
            ready = [i for i in range(len(items))
                     if items[i].scalars is not None]
            if len(ready) > 1:
                handle.pre_dispatch(runner, ready)
        return handle

    def _group_ready(self, items: list, ready: list) -> list:
        """(key, item-index chunk) batches for the ready items — the
        same grouping rule whether the chunks run inline, pre-dispatch
        as shards, or split across lent workers."""
        groups: dict = {}
        for i in ready:
            it = items[i]
            groups.setdefault((it.bases_id, len(it.scalars)),
                              []).append(i)
        out = []
        for key, idxs in groups.items():
            for j in range(0, len(idxs), MAX_BATCH):
                out.append((key, idxs[j : j + MAX_BATCH]))
        return out

    def _split_parts(self, key: tuple, group: list, fanout: int) -> list:
        """The ONE split policy for a grouped chunk under a fan-out —
        shared by the inline path (:meth:`_commit_chunk`) and the
        pre-dispatch path (:meth:`FlushHandle.pre_dispatch`) so the two
        can never group differently. Splitting never changes bytes —
        every column is bit-exact against the serial oracle in any
        grouping — so this is placement, not semantics. When a split
        happens, the bases limb cache is materialized on the
        dispatching thread first: two lent workers racing the
        params-level cache would both pay the conversion."""
        from . import shards

        if fanout <= 1 or len(group) <= 1 or self.device:
            return [group]
        self._bases(*key)  # warm the shared limb cache pre-dispatch
        return [group[a:b]
                for a, b in shards.split_ranges(len(group), fanout)]

    def _commit_chunk(self, items: list, key: tuple, chunk: list) -> None:
        """One grouped chunk, split across the shard fan-out when a
        runner is active (see :meth:`_split_parts`)."""
        from . import shards

        group = [items[i] for i in chunk]
        parts = self._split_parts(key, group, shards.shard_fanout())
        if len(parts) == 1:
            self._commit_group(key, group)
            return
        shards.shard_map(
            "commit",
            [lambda p=p: self._commit_group(key, p) for p in parts],
            portables=[self._commit_portable(key, p) for p in parts])

    def _fetch_loop(self, fetches: list, ctx_ids: tuple,
                    worker: str | None) -> None:
        import contextlib

        with contextlib.ExitStack() as stack:
            if ctx_ids:
                stack.enter_context(trace.context(trace_ids=ctx_ids))
            if worker is not None:
                stack.enter_context(trace.worker_context(worker))
            for it in fetches:
                try:
                    scalars = it.fetch()
                except BaseException as e:  # surfaced by flush()
                    with self._cv:
                        it.error = e
                        self._cv.notify_all()
                    return
                with self._cv:
                    it.scalars = scalars
                    self._cv.notify_all()

    def _bases(self, bases_id: str, length: int) -> np.ndarray:
        from . import prover_fast as pf

        if bases_id == "lagrange":
            return pf.lagrange_limbs(self.params)
        return pf.srs_limbs(self.params)[:length]

    def _device_base_points(self, bases_id: str, length: int,
                            bases: np.ndarray) -> list:
        cached = self._device_pts.get((bases_id, length))
        if cached is None:
            vals = native.limbs_to_ints(
                np.ascontiguousarray(bases).reshape(-1, 4))
            cached = []
            for i in range(length):
                x, y = vals[2 * i], vals[2 * i + 1]
                cached.append(None if x == 0 and y == 0 else (x, y))
            self._device_pts[(bases_id, length)] = cached
        return cached

    def _commit_group(self, key: tuple, group: list) -> None:
        bases_id, length = key
        trace.histogram("commit_batch_size",
                        buckets=trace.COMMIT_BATCH_BUCKETS).observe(
            float(len(group)), bases=bases_id)
        bases = self._bases(bases_id, length)
        if self.device:
            from ..device import resolve_device

            dev = resolve_device(self.msm_device)
            pts = self._device_base_points(bases_id, length, bases)
            for it in group:
                it.point = _device_msm(pts, it.scalars, dev)
        elif self.batching:
            cols = []
            for it in group:
                cols.append(np.ascontiguousarray(it.scalars))
                it.scalars = None  # fetched chunks (~32-64 MB each)
                # free as soon as the stack below owns their bytes
            stack = np.stack(cols)
            del cols
            balanced, flips = balance_columns(stack)  # in place
            points = native.g1_msm_multi(Q, bases, balanced, flips)
            del stack, balanced
            for it, pt in zip(group, points):
                it.point = pt
        else:  # serial oracle path (PTPU_COMMIT_ENGINE=0)
            from .prover_fast import _msm_signed

            for it in group:
                if bases_id == "lagrange":
                    it.point = _msm_signed(bases, it.scalars)
                else:
                    it.point = native.g1_msm(Q, bases, it.scalars)
        self._finish_group(group)

    def _finish_group(self, group: list) -> None:
        """The blinds tail, factored so the cross-process apply path
        (``_commit_portable``) and the local ``_commit_group`` share
        one copy: frees scalars and folds each item's Z_H-blinding
        τ-basis correction into its point. Blinds are applied HERE, on
        the submitting side, never on an external worker — the wire
        carries no values derived from the blinding stream."""
        n = 1 << self.params.k
        for it in group:
            it.scalars = None  # fetched chunks can be ~32 MB each
            for i, b in enumerate(it.blinds):
                if b == 0:
                    continue
                it.point = g1_add(it.point,
                                  g1_mul(self.params.g1_powers[n + i], b))
                it.point = g1_add(it.point,
                                  g1_mul(self.params.g1_powers[i],
                                         (R - b) % R))

    def _commit_portable(self, key: tuple, group: list):
        """The cross-process face of one grouped commit part (see
        ``zk/fabric.py``): payload = the stacked scalar columns plus
        the base limbs as a content-addressed SHARED blob (every commit
        unit of a prove references the same bases — they serialize once
        per prove, not per unit); apply = set the returned affine
        points and run the local blinds tail. None when the unit can't
        travel (device seam / serial oracle path)."""
        if self.device or not self.batching:
            return None
        from .fabric import FabricError, PortableUnit, Shared

        def build():
            # np.stack copies — the items' own scalar arrays are never
            # mutated by serialization, so a local fallback run after a
            # failed remote apply sees pristine inputs
            cols = np.stack([np.ascontiguousarray(it.scalars)
                             for it in group])
            return {"cols": cols, "bases": Shared(self._bases(*key)),
                    "bases_id": key[0], "length": key[1]}

        def apply(res):
            pts = res.get("points") if isinstance(res, dict) else None
            if pts is None or len(pts) != len(group):
                raise FabricError("commit result shape mismatch")
            trace.histogram("commit_batch_size",
                            buckets=trace.COMMIT_BATCH_BUCKETS).observe(
                float(len(group)), bases=key[0])
            for it, pt in zip(group, pts):
                it.point = (None if pt is None
                            else (int(pt[0]), int(pt[1])))
            self._finish_group(group)
            return None

        return PortableUnit("commit", build, apply)


class FlushHandle:
    """Result-rendezvous of one engine flush: the addressable-shard
    form of the old blocking loop. ``result()`` is the ONE merge point
    — it finishes fetch-backed items, claims whatever pre-dispatched
    units no lent worker took, waits for the rest, and returns points
    in submission order (the transcript absorbs them there). Errors
    from any side (fetch thread, lent worker, inline commit) surface
    here, after every claimed unit has completed — a lent worker
    cannot be interrupted mid-MSM."""

    def __init__(self, eng: CommitEngine, items: list):
        self.eng = eng
        self.items = items
        self.fetch_thread = None
        self.units: list = []
        self._runner = None
        self._covered: set = set()
        self._done = False
        self._error = None  # first failure, re-raised on every call

    def pre_dispatch(self, runner, ready: list) -> None:
        """Group the already-materialized items and hand them to the
        runner NOW (non-blocking): lent workers start on the MSMs while
        the caller holds its device-occupancy window (or keeps
        absorbing fetches). Called by ``flush_async`` only."""
        from . import shards

        units = []
        fanout = max(1, int(getattr(runner, "fanout", 1)))
        for key, chunk in self.eng._group_ready(self.items, ready):
            group = [self.items[i] for i in chunk]
            parts = self.eng._split_parts(key, group, fanout)
            for p in parts:
                units.append(shards.ShardUnit(
                    "commit",
                    (lambda key=key, p=p:
                     self.eng._commit_group(key, p)),
                    len(units),
                    trace_ids=trace.current_trace_ids(),
                    portable=self.eng._commit_portable(key, p)))
            self._covered.update(chunk)
        runner.dispatch(units)
        self._runner = runner
        self.units = units

    def result(self) -> list:
        """Complete the flush and return points in submission order.
        Idempotent: repeated calls return the same points — or re-raise
        the SAME error (a failed flush must never degrade into a point
        list with silent None holes on retry)."""
        if self._done:
            if self._error is not None:
                raise self._error
            return [it.point for it in self.items]
        self._done = True
        items = self.items
        eng = self.eng
        err = None
        try:
            pending = set(range(len(items))) - self._covered
            while pending:
                with eng._cv:
                    while True:
                        e = next((items[i].error for i in pending
                                  if items[i].error is not None), None)
                        if e is not None:
                            raise e
                        ready = [i for i in sorted(pending)
                                 if items[i].scalars is not None]
                        if ready:
                            break
                        eng._cv.wait()
                for key, chunk in eng._group_ready(items, ready):
                    eng._commit_chunk(items, key, chunk)
                    pending.difference_update(chunk)
        except BaseException as e:  # noqa: BLE001 - rendezvous below
            err = e  # must still drain claimed units before raising
        finally:
            if self._runner is not None and self.units:
                try:
                    self._runner.rendezvous(self.units)
                except BaseException as e2:  # noqa: BLE001
                    err = err or e2
            if self.fetch_thread is not None:
                self.fetch_thread.join()
        if err is not None:
            self._error = err
            raise err
        return [it.point for it in items]


def _device_msm(pts: list, scalars: np.ndarray, device):
    """One column through the sorted-prefix device MSM on ``device``:
    identity bases and zero scalars are dropped, as the host oracle
    drops them."""
    from ..ops.msm_device import msm_device

    sc = native.limbs_to_ints(np.ascontiguousarray(scalars))
    pairs = [(p, s % R) for p, s in zip(pts, sc) if p is not None and s % R]
    if not pairs:
        return None
    return msm_device([p for p, _ in pairs], [s for _, s in pairs],
                      device=device)
