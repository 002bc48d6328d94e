"""DeltaEngine: keep a compiled routed operator current under edge churn.

The port of ``protocol_tpu/incremental/engine.py``. The routed operator
(``ops/routed.py``) is a compiled artifact: blocked ELL value buffers
plus two Clos routing programs, whose full build is O(E log E) host work
(the plan build dominates). But almost no attestation *changes the
routing*:

- most revise the weight of an existing (signer, about) edge — the
  routing program is untouched, only one value in one ``out_weight``
  buffer changes;
- a removal (value → 0) likewise only zeroes a value;
- a structural insert adds an edge the plan has no slot for — it goes
  to a bounded COO **overflow tail** that ``spmv_routed`` folds in with
  one scatter-add, and the plan rebuild is deferred until the tail
  crosses its budget;
- any of these dirties the source row's normalization — repaired by a
  per-source ``inv_row_scale`` vector (``row_sum_at_build /
  row_sum_now``) instead of rescattering O(out-degree) slots per
  revision.

The engine anchors on one full build and absorbs churn batches in
O(dirty) host work plus O(dirty) device writes. Where the reference
rebuilds each patched array functionally (``.at[].set``), the port
writes in place into tensors that the engine owns: it copies every array
it patches at anchor time, so a patch never reaches the operator's host
arrays or another caller's ``routed_arrays``. Its sweeps are
``ops.routed.spmv_routed`` with the ``inv_row_scale`` and ``tail_*``
keys, whose Clos routes run kernel B1 on the card.

Capacity walls — free state slots exhausted (new peers beyond the
build's padding), overflow tail past ``tail_max``/``tail_fraction`` —
flip :meth:`DeltaEngine.apply_deltas` to False: the caller falls back
to a full rebuild (rare and amortized by design) and re-anchors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from ..device import resolve_device
from ..graph import filter_edges, stable_argsort_bounded
from ..utils import trace

_KEY_SHIFT = 32  # node ids fit 31 bits (asserted by the routed build)


def expand_csr(ptr: np.ndarray, nodes: np.ndarray):
    """CSR range expansion, the one copy of the idiom every traversal
    in this package uses: for each node in ``nodes`` the flat positions
    ``ptr[node]..ptr[node+1]``, returned as ``(rows, pos)`` where
    ``rows[i]`` indexes into ``nodes`` and ``pos[i]`` is the position
    (feed it through an order array for the in-side view)."""
    cnt = (ptr[nodes + 1] - ptr[nodes]).astype(np.int64)
    total = int(cnt.sum())
    if not total:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    rows = np.repeat(np.arange(len(nodes)), cnt)
    starts = np.repeat(ptr[nodes], cnt)
    local = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return rows, starts + local


def revision_batch(rng, fsrc, fdst, cur, batch_edges: int) -> list:
    """One random weight-revision batch over the filtered edge arrays:
    ``[(src, dst, old, new)]`` with ``cur`` (the caller's current raw
    values, same order as ``fsrc``/``fdst``) updated in place. The ONE
    churn generator shared by bench.py --churn, the profile/perf-gate
    delta workload, and the serve-smoke churn phase — the delta tuple
    shape and the raw-view contract must not drift between them (a copy
    of the reference's, so both packages draw the same batches from one
    seed)."""
    idx = rng.choice(len(fsrc), batch_edges, replace=False)
    deltas = []
    for e in idx:
        new = float(rng.integers(1, 11))
        deltas.append((int(fsrc[e]), int(fdst[e]), float(cur[e]), new))
        cur[e] = new
    return deltas


def _edge_key(src, dst):
    return (np.asarray(src, dtype=np.int64) << _KEY_SHIFT) | np.asarray(
        dst, dtype=np.int64)


@dataclass
class DeltaStats:
    """Cumulative classification counts since the anchor build."""

    batches: int = 0
    revisions: int = 0
    inserts: int = 0
    removes: int = 0
    renormalized_rows: int = 0
    new_peers: int = 0
    rebuild_reason: str | None = None


class DeltaEngine:
    """One anchored routed operator + its delta-maintained device state.

    Built by :meth:`anchor` from the exact edge arrays a routed
    operator was compiled from; thereafter :meth:`apply_deltas` folds
    the service's edge-change log in and :meth:`converge` /
    ``incremental.partial_refresh`` produce scores without ever
    recompiling the routing plan. The device arrays live on ``device``
    (``cuda`` unless the caller names another) in ``dtype`` (float32
    unless named), which also sets the dtype of the ladder's device
    sweeps (``incremental.device``).
    """

    def __init__(self):  # populated by anchor()
        raise TypeError("use DeltaEngine.anchor(...)")

    # --- anchor -----------------------------------------------------------
    @classmethod
    def anchor(cls, n, src, dst, val, valid, op, dtype=None,
               alpha: float = 0.0, tail_max: int = 1 << 16, tail_fraction: float = 0.25,
               device=None):
        """Anchor on ``op`` (a RoutedOperator) and the raw edge arrays
        it was built from. O(E) numpy — amortized into the full build
        this replaces many of."""
        from ..ops.routed import ensure_edge_slots, routed_arrays

        self = object.__new__(cls)
        self.device = resolve_device(device)
        fsrc, fdst, fweight, valid_mask, dangling, raw_val, row_sum = \
            filter_edges(n, src, dst, val, valid, return_raw=True)
        ensure_edge_slots(op, fsrc, fdst, fweight)
        self.op = op
        self.dtype = dtype or torch.float32
        self.np_dtype = torch.empty(0, dtype=self.dtype).numpy().dtype
        self.alpha = float(alpha)
        self.n0 = int(n)              # peers at anchor
        self.n_now = int(n)
        self.nnz0 = len(fsrc)

        # --- edge index: filtered order IS (src, dst)-lexicographic ---
        self.fsrc = fsrc.astype(np.int64)
        self.fdst = fdst.astype(np.int64)
        self.key = _edge_key(fsrc, fdst)
        self.raw_val = raw_val.astype(np.float64).copy()
        self.slot = np.asarray(op.out_edge_slot, dtype=np.int64)
        # live-edge counters maintained incrementally by _classify —
        # nnz_now must stay O(1): counting nonzeros over the anchored
        # arrays would put an O(E) pass on every delta-served refresh
        self._live_built = int(np.count_nonzero(self.raw_val > 0))
        self._live_tail = 0

        # --- row accounting -------------------------------------------
        self.row_sum0 = np.asarray(row_sum, dtype=np.float64).copy()
        self.row_sum_now = self.row_sum0.copy()
        self.valid_np = np.asarray(valid_mask, dtype=bool).copy()
        self.dangling_np = np.asarray(dangling, dtype=bool).copy()
        self.n_valid = int(valid_mask.sum())
        self._n_valid0 = self.n_valid

        # --- CSR views for the partial refresher ----------------------
        # filtered order is sorted by src: out-CSR is a prefix-sum away
        self.out_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.fsrc, minlength=n), out=self.out_ptr[1:])
        self.in_order = stable_argsort_bounded(self.fdst, n)
        self.in_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self.fdst, minlength=n), out=self.in_ptr[1:])

        # --- state-space bookkeeping ----------------------------------
        self.state_to_node = np.asarray(op.state_to_node,
                                        dtype=np.int64).copy()
        self.node_to_state = np.full(n, -1, dtype=np.int64)
        live = self.state_to_node >= 0
        self.node_to_state[self.state_to_node[live]] = np.nonzero(live)[0]
        self.free_slots = np.nonzero(~live)[0]
        self._free_ptr = 0
        self.valid_state = np.asarray(op.valid, dtype=np.float32).copy()

        # --- bucket geometry for slot -> (bucket, row, lane) ----------
        sizes = [int(x) * 128 for x in op.out_xs]
        self.bucket_base = np.concatenate(
            ([0], np.cumsum(sizes))).astype(np.int64)

        # --- overflow tail (host truth; device arrays derived) --------
        self.tail_max = int(tail_max)
        self.tail_fraction = float(tail_fraction)
        self.tail_src_np = np.zeros(0, dtype=np.int64)   # node ids
        self.tail_dst_np = np.zeros(0, dtype=np.int64)
        self.tail_raw_np = np.zeros(0, dtype=np.float64)
        self.tail_index: dict = {}       # edge key -> tail position
        # per-ROW tail indexes, maintained incrementally at insert time
        # (entries live until re-anchor; removed edges keep their slot
        # with raw 0 and are skipped at use). These are what keep the
        # partial refresher's fan-in/fan-out O(adjacent tail edges)
        # instead of a linear scan over the WHOLE tail per sweep —
        # past ~10^4 tail edges the scan dominated every churn batch.
        self.tail_by_src: dict = {}      # src node -> [tail positions]
        self.tail_by_dst: dict = {}      # dst node -> [tail positions]
        # observability + regression hook: how many tail entries the
        # fan-in/fan-out traversals actually examined (O(hits), not
        # O(tail) — asserted by tests/test_incremental.py)
        self.tail_fanin_visited = 0
        self.tail_fanout_visited = 0
        # ext-weight recompute scope: rows whose external out-weight
        # was computed from their out-edges. Frontier EXPANSIONS update incrementally —
        # fresh computation only for the appended rows, a subtraction
        # for the boundary-crossing rows — so this grows by
        # O(new rows) per expansion, not O(frontier)
        # (tests/test_sublinear.py asserts the scope).
        self.ext_weight_rows_computed = 0

        # --- device state ---------------------------------------------
        # the engine patches these in place: its own copies, never
        # storage shared with the operator (routed_arrays may alias a
        # host array on the CPU) or with another caller
        arrs, static = routed_arrays(op, dtype=self.dtype, alpha=alpha,
                                     device=self.device)
        arrs["out_weight"] = tuple(w.clone() for w in arrs["out_weight"])
        for k in ("valid", "dangling", "n_valid", "pretrust"):
            arrs[k] = arrs[k].clone()
        arrs["inv_row_scale"] = torch.ones(op.n_state, dtype=self.dtype,
                                           device=self.device)
        # the COO tail, one entry per tail edge (none at anchor)
        arrs["tail_src"] = torch.zeros(0, dtype=torch.int64,
                                       device=self.device)
        arrs["tail_dst"] = torch.zeros(0, dtype=torch.int64,
                                       device=self.device)
        arrs["tail_w"] = torch.zeros(0, dtype=self.dtype,
                                     device=self.device)
        self.arrs = arrs
        self.static = static

        # --- churn bookkeeping ----------------------------------------
        self.dirty_rows: set = set()       # rows renormalized vs build
        # nodes whose fan-in changed, accumulated as a LIST of int64
        # array parts — one unique+sort at drain time (take_frontier),
        # not a full re-sort of the accumulated frontier per batch
        # (O(batches · |F| log |F|) under one-attestation churn). The
        # refreshers consume the drained SORTED ndarray directly — a
        # set here meant an O(|F|) per-element int() rematerialization
        # per refresh, interpreter-bound past ~10^5 dirty nodes
        self.pending_frontier: list = []
        self.pending_new_peers = False      # since last frontier drain
        self._new_valid_slots: list = []   # device patches queued by
        self._new_dangling: dict = {}      # _grow_nodes for _classify
        self._n_valid_dev = self.n_valid   # n_valid the device has
        self.stats = DeltaStats()
        return self

    # --- introspection ----------------------------------------------------
    @property
    def nnz_now(self) -> int:
        return self._live_built + self._live_tail

    @property
    def tail_live(self) -> int:
        return self._live_tail

    def should_rebuild(self) -> str | None:
        """Deferred-rebuild policy: the reason a background full build
        is now due, or None while the engine is within budget."""
        if self.stats.rebuild_reason:
            return self.stats.rebuild_reason
        if len(self.tail_index) > self.tail_max:
            return "tail_max"
        if len(self.tail_index) > self.tail_fraction * max(self.nnz0, 1):
            return "tail_fraction"
        return None

    # --- delta application ------------------------------------------------
    def apply_deltas(self, deltas, n: int | None = None) -> bool:
        """Fold ``[(src_id, dst_id, old_val, new_val)]`` in; True when
        absorbed, False when the batch hits a capacity wall (caller
        rebuilds + re-anchors; the engine is dead afterwards).
        ``n``: the graph's CURRENT peer count — peers can be interned
        without any edge change (duplicate attestations), and a
        from-scratch rebuild would still include them as valid dangling
        slots, so the engine grows to ``n`` even without deltas.

        Timing is attributed per delta kind on
        ``ptpu_operator_delta_seconds{kind}``:
        ``classify`` (host index + row accounting), ``revise``
        (in-place value-buffer patches), ``structural`` (overflow-tail
        maintenance), ``renorm`` (dirty-row rescale + dangling/valid
        patches). The device writes are enqueued, not awaited: a caller
        timing a batch synchronises the device first.
        """
        if self.stats.rebuild_reason:
            return False
        if n is not None and n > self.n_now and not self._grow_nodes(n):
            return False
        if not deltas:
            if self._new_valid_slots or self._new_dangling:
                self._renormalize(np.zeros(0, dtype=np.int64),
                                  (list(self._new_valid_slots),
                                   dict(self._new_dangling)))
                self._new_valid_slots, self._new_dangling = [], {}
            return True
        with trace.timed("operator_delta_seconds", "delta.classify",
                         labels={"kind": "classify"}, n=len(deltas)):
            plan = self._classify(deltas)
        if plan is None:
            return False
        with trace.timed("operator_delta_seconds", "delta.revise",
                         labels={"kind": "revise"},
                         n=len(plan["slot_patches"][0])):
            self._patch_values(*plan["slot_patches"])
        with trace.timed("operator_delta_seconds", "delta.structural",
                         labels={"kind": "structural"},
                         n=plan["tail_touched"]):
            self._sync_tail(plan["tail_touched"], plan["touched_rows"])
        with trace.timed("operator_delta_seconds", "delta.renorm",
                         labels={"kind": "renorm"},
                         n=len(plan["touched_rows"])):
            self._renormalize(plan["touched_rows"],
                              plan["state_patches"])
        self.stats.batches += 1
        trace.gauge("dirty_rows").set(float(len(self.dirty_rows)))
        trace.event("delta.applied", n=len(deltas),
                    revisions=self.stats.revisions,
                    inserts=self.stats.inserts,
                    removes=self.stats.removes,
                    tail=len(self.tail_index),
                    dirty_rows=len(self.dirty_rows))
        return True

    def _grow_nodes(self, new_n: int) -> bool:
        """Extend per-node arrays and assign state slots to new peers;
        False when the build's free state slots are exhausted."""
        add = new_n - self.n_now
        if add <= 0:
            return True
        if self._free_ptr + add > len(self.free_slots):
            self.stats.rebuild_reason = "state_slots_exhausted"
            return False
        slots = self.free_slots[self._free_ptr:self._free_ptr + add]
        self._free_ptr += add
        ids = np.arange(self.n_now, new_n, dtype=np.int64)
        self.state_to_node[slots] = ids
        self.node_to_state = np.concatenate([self.node_to_state, slots])
        grow0 = np.zeros(add)
        self.row_sum0 = np.concatenate([self.row_sum0, grow0])
        self.row_sum_now = np.concatenate([self.row_sum_now, grow0])
        # the service's peer set is all-valid; a new peer starts with no
        # out-edges (dangling) until its first surviving edge lands
        self.valid_np = np.concatenate(
            [self.valid_np, np.ones(add, dtype=bool)])
        self.dangling_np = np.concatenate(
            [self.dangling_np, np.ones(add, dtype=bool)])
        self.valid_state[slots] = 1.0
        self.n_valid += add
        self.n_now = new_n
        self.stats.new_peers += add
        self.pending_new_peers = True
        for s in slots:
            self._new_valid_slots.append(int(s))
            # a fresh peer has no out-edges yet: dangling until its
            # first surviving edge flips it in the same/next batch
            self._new_dangling[int(s)] = 1.0
        # every new peer is frontier: its score starts undefined
        self.pending_frontier.append(np.asarray(ids, dtype=np.int64))
        return True

    def _classify(self, deltas) -> dict | None:
        """Host pass: index lookups, row accounting, tail bookkeeping.
        Returns the device patch plan, or None on a capacity wall.

        Vectorized for the dominant shape (built-edge weight
        revisions): one searchsorted over the batch, one np.add.at for
        the row sums (duplicate keys telescope: Σ(new−old) per chain =
        last−first), keep-last semantics for the value writes. Only
        index MISSES — overflow-tail traffic and brand-new edges — walk
        a Python loop, in batch order so an insert-then-revise chain
        within one batch lands correctly."""
        m = len(deltas)
        i_arr = np.fromiter((d[0] for d in deltas), np.int64, count=m)
        j_arr = np.fromiter((d[1] for d in deltas), np.int64, count=m)
        old_arr = np.fromiter(
            (d[2] if d[2] is not None and d[2] > 0 else 0.0
             for d in deltas), np.float64, count=m)
        new_arr = np.fromiter(
            (d[3] if d[3] is not None and d[3] > 0 else 0.0
             for d in deltas), np.float64, count=m)
        live = (i_arr != j_arr) & (old_arr != new_arr)
        i_arr, j_arr = i_arr[live], j_arr[live]
        old_arr, new_arr = old_arr[live], new_arr[live]
        if len(i_arr):
            max_id = int(max(i_arr.max(), j_arr.max()))
            if max_id >= self.n_now and not self._grow_nodes(max_id + 1):
                return None

        key_arr = _edge_key(i_arr, j_arr)
        pos = np.searchsorted(self.key, key_arr)
        pos_c = np.minimum(pos, max(len(self.key) - 1, 0))
        found = ((pos < len(self.key)) & (self.key[pos_c] == key_arr)
                 if len(self.key) else np.zeros(len(pos), dtype=bool))

        # --- built edges: weight revision / removal / revival ---------
        bpos, bnew = pos[found], new_arr[found]
        if len(bpos):
            _, last = np.unique(bpos[::-1], return_index=True)
            keep = len(bpos) - 1 - last
            old_live = self.raw_val[bpos[keep]] > 0
            self.raw_val[bpos[keep]] = bnew[keep]
            self._live_built += int((bnew[keep] > 0).sum()) \
                - int(old_live.sum())
            self.stats.revisions += int((bnew > 0).sum())
            self.stats.removes += int((bnew == 0).sum())
        slot_patches = (self.slot[bpos],
                        bnew / self.row_sum0[i_arr[found]])

        # --- misses: overflow tail / brand-new edges (batch order) ----
        # new entries accumulate in Python lists and concatenate ONCE
        # after the loop — per-edge np.append would copy the whole tail
        # per insert, O(tail^2) toward the tail_max budget
        tail_touched = 0
        dropped = np.zeros(len(i_arr), dtype=bool)
        base_len = len(self.tail_raw_np)
        pend_src: list = []
        pend_dst: list = []
        pend_raw: list = []
        if not found.all():
            for x in np.nonzero(~found)[0]:
                i, j, new_v = int(i_arr[x]), int(j_arr[x]), new_arr[x]
                k = int(key_arr[x])
                ti = self.tail_index.get(k)
                if ti is not None:
                    if ti >= base_len:  # inserted earlier THIS batch
                        old_tv = pend_raw[ti - base_len]
                        pend_raw[ti - base_len] = new_v
                    else:
                        old_tv = self.tail_raw_np[ti]
                        self.tail_raw_np[ti] = new_v
                    self._live_tail += int(new_v > 0) - int(old_tv > 0)
                    self.stats.revisions += 1 if new_v > 0 else 0
                    self.stats.removes += 1 if new_v == 0 else 0
                elif new_v > 0:
                    if len(self.tail_index) + 1 > self.tail_max:
                        self.stats.rebuild_reason = "tail_max"
                        return None
                    ti = base_len + len(pend_raw)
                    self.tail_index[k] = ti
                    self.tail_by_src.setdefault(i, []).append(ti)
                    self.tail_by_dst.setdefault(j, []).append(ti)
                    pend_src.append(i)
                    pend_dst.append(j)
                    pend_raw.append(new_v)
                    self._live_tail += 1
                    self.stats.inserts += 1
                else:
                    dropped[x] = True  # removing a never-present edge
                    continue
                tail_touched += 1
        if pend_raw:
            self.tail_src_np = np.concatenate(
                [self.tail_src_np,
                 np.asarray(pend_src, dtype=np.int64)])
            self.tail_dst_np = np.concatenate(
                [self.tail_dst_np,
                 np.asarray(pend_dst, dtype=np.int64)])
            self.tail_raw_np = np.concatenate(
                [self.tail_raw_np, np.asarray(pend_raw)])
        if dropped.any():
            keep_live = ~dropped
            i_arr, j_arr = i_arr[keep_live], j_arr[keep_live]
            old_arr, new_arr = old_arr[keep_live], new_arr[keep_live]

        # --- row accounting (duplicates telescope) --------------------
        np.add.at(self.row_sum_now, i_arr, new_arr - old_arr)
        touched_rows = np.unique(i_arr)
        self.dirty_rows.update(touched_rows.tolist())

        # --- dangling transitions + frontier fan-out ------------------
        dangling_patches: dict = dict(self._new_dangling)  # slot -> val
        self._new_dangling = {}
        now_d = self.valid_np[touched_rows] & (
            self.row_sum_now[touched_rows] <= 1e-300)
        trans = now_d != self.dangling_np[touched_rows]
        for u, nd in zip(touched_rows[trans], now_d[trans]):
            dangling_patches[int(self.node_to_state[u])] = (
                1.0 if nd else 0.0)
        self.dangling_np[touched_rows] = now_d
        frontier_parts = [j_arr, touched_rows[trans]]
        tb = touched_rows[touched_rows < self.n0]
        _, pos = expand_csr(self.out_ptr, tb)
        if len(pos):
            frontier_parts.append(self.fdst[pos])
        if self.tail_by_src:
            for u in touched_rows.tolist():
                for ti in self.tail_by_src.get(u, ()):
                    frontier_parts.append(
                        self.tail_dst_np[ti:ti + 1].astype(np.int64))
        self.pending_frontier.extend(frontier_parts)

        state_valid_idx = list(self._new_valid_slots)
        self._new_valid_slots = []
        return {
            "slot_patches": slot_patches,
            "touched_rows": touched_rows,
            "tail_touched": tail_touched,
            "state_patches": (state_valid_idx, dangling_patches),
        }

    def device_array(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the engine's device, in the engine's dtype
        unless ``dtype`` names another (int64 for indices)."""
        a = np.ascontiguousarray(a, dtype=self.np_dtype if dtype is None
                                 else dtype)
        return torch.from_numpy(a).to(self.device)

    def _patch_values(self, slots: np.ndarray, vals: np.ndarray) -> None:
        """Write revised normalized values into the out_weight device
        buffers in place, one indexed write per touched bucket."""
        if not len(slots):
            return
        # later patches win within a batch (a key revised twice): keep
        # only the LAST write per slot — the write order for duplicate
        # indices is undefined
        _, last = np.unique(slots[::-1], return_index=True)
        keep = len(slots) - 1 - last
        slots, vals = slots[keep], vals[keep]
        bi = np.searchsorted(self.bucket_base, slots, side="right") - 1
        weights = self.arrs["out_weight"]
        for b in np.unique(bi):
            m = bi == b
            local = slots[m] - self.bucket_base[b]
            weights[b].index_put_(
                (self.device_array(local // 128, np.int64),
                 self.device_array(local % 128, np.int64)),
                self.device_array(vals[m]))

    def _sync_tail(self, tail_touched: int,
                   touched_rows: np.ndarray) -> None:
        """Re-derive the device COO tail from host truth. Tail weights
        are TRUE normalized weights (val / row_sum_now) so they need no
        inv_row_scale; rows with built edges get their scale corrected
        in _renormalize, which keeps the whole row summing to 1."""
        n_tail = len(self.tail_raw_np)
        if n_tail == 0:
            return
        # a batch with no tail delta still needs a re-derive when a
        # built-edge revision moved row_sum_now of a row that ALSO has
        # tail edges (tail stores TRUE weights val/row_sum_now) — but
        # the dominant pure-revision batch away from tail rows skips
        # the O(tail) recompute + device upload entirely
        if not tail_touched and not any(
                int(u) in self.tail_by_src for u in touched_rows):
            return
        denom = self.row_sum_now[self.tail_src_np]
        w = np.divide(self.tail_raw_np, denom,
                      out=np.zeros(n_tail), where=denom > 0)
        self.arrs["tail_src"] = self.device_array(
            self.node_to_state[self.tail_src_np], np.int64)
        self.arrs["tail_dst"] = self.device_array(
            self.node_to_state[self.tail_dst_np], np.int64)
        self.arrs["tail_w"] = self.device_array(w)

    def _renormalize(self, touched_rows: np.ndarray,
                     state_patches) -> None:
        """Dirty-row normalization repair + dangling/valid mask patches
        — O(dirty) in-place device writes."""
        valid_idx, dangling_patches = state_patches
        rows = touched_rows
        if len(rows):
            # tail rows whose row_sum_now changed need their built-edge
            # scale refreshed too (tail weights were just re-derived)
            s0 = self.row_sum0[rows]
            s1 = self.row_sum_now[rows]
            scale = np.where((s0 > 0) & (s1 > 0), s0 / np.where(
                s1 > 0, s1, 1.0), 1.0)
            self.arrs["inv_row_scale"].index_put_(
                (self.device_array(self.node_to_state[rows], np.int64),),
                self.device_array(scale))
            self.stats.renormalized_rows += len(rows)
        if dangling_patches:
            idx = np.fromiter(dangling_patches.keys(), dtype=np.int64,
                              count=len(dangling_patches))
            val = np.fromiter(dangling_patches.values(),
                              dtype=np.float64,
                              count=len(dangling_patches))
            self.arrs["dangling"].index_put_(
                (self.device_array(idx, np.int64),), self.device_array(val))
        if valid_idx:
            self.arrs["valid"][self.device_array(valid_idx, np.int64)] = 1.0
        if self.n_valid != self._n_valid_dev:
            self.arrs["n_valid"].fill_(float(self.n_valid))
            # uniform pre-trust over the CURRENT valid set (only read
            # when alpha > 0, but kept correct unconditionally)
            self.arrs["pretrust"].copy_(self.arrs["valid"] / torch.clamp(
                self.arrs["n_valid"], min=1.0))
            self._n_valid_dev = self.n_valid

    # --- frontier handoff to the partial refresher ------------------------
    def take_frontier(self):
        """(frontier_node_ids, partial_ok): the accumulated dirty
        frontier since the last drain — a SORTED unique int64 ndarray,
        handed over as-is (no per-element materialization) — cleared.
        ``partial_ok`` is False when the window added peers (n_valid
        changed → the published vector is not a near-fixed-point of the
        new operator for ANY node, so a partial sweep has no
        footing)."""
        parts = self.pending_frontier
        self.pending_frontier = []
        if parts:
            frontier = np.unique(
                np.concatenate(parts).astype(np.int64, copy=False))
        else:
            frontier = np.zeros(0, dtype=np.int64)
        ok = not self.pending_new_peers
        self.pending_new_peers = False
        return frontier, ok

    def restore_frontier(self, frontier, partial_ok: bool) -> None:
        """Put a drained frontier back (failed refresh: the retry must
        still see it)."""
        from .partial import as_frontier_array

        self.pending_frontier.append(as_frontier_array(frontier))
        if not partial_ok:
            self.pending_new_peers = True

    # --- score translation ------------------------------------------------
    def scores_to_state(self, node_scores) -> np.ndarray:
        """Node-order → state-order (warm-start entry), against the
        engine's EXTENDED id space (new peers included)."""
        node_scores = np.asarray(node_scores, dtype=np.float64)
        out = np.zeros(len(self.state_to_node), dtype=np.float64)
        live = self.state_to_node >= 0
        out[live] = node_scores[self.state_to_node[live]]
        return (out * self.valid_state).astype(self.np_dtype)

    def scores_to_nodes(self, state_scores) -> np.ndarray:
        state_scores = np.asarray(state_scores)
        out = np.zeros(self.n_now, dtype=state_scores.dtype)
        live = self.state_to_node >= 0
        out[self.state_to_node[live]] = state_scores[live]
        return out

    def initial_node_scores(self, initial_score: float) -> np.ndarray:
        return self.valid_np.astype(np.float64) * float(initial_score)

    # --- device converge on the PATCHED operator --------------------------
    def converge(self, s0_node, max_iterations: int, tol: float):
        """Adaptive device converge through the patched matvec — full
        sweeps (kernel B1 on every route stage on the card), zero plan
        rebuilds. Reported as ``backend="torch-routed-delta"``. Returns
        (node_scores, iters, delta)."""
        from ..ops.converge import timed_converge
        from ..ops.routed import converge_routed_adaptive

        s0 = torch.from_numpy(self.scores_to_state(s0_node)).to(self.device)
        scores, iters, delta = timed_converge(
            "torch-routed-delta", self.n_now, self.nnz_now,
            lambda: converge_routed_adaptive(
                self.arrs, self.static, s0, tol=tol,
                max_iterations=max_iterations))
        return (self.scores_to_nodes(scores.cpu().numpy()), int(iters),
                float(delta))
