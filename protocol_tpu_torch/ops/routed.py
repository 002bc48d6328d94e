"""Clos-routed sparse converge on torch: the counterpart of
``protocol_tpu/ops/routed.py``.

One sweep of the power iteration runs without a general gather:

1. **broadcast**: edge values ``s[src]·w`` materialize in source-major
   order; each node's score is broadcast across its out-row lanes;
2. **edge route**: the edge array moves from source-major to
   destination-major order through a Clos network of lane permutations
   and transposes (``ops.clos``): the sparse transpose as a
   permutation-network program;
3. **reduce**: lane-segmented sums collapse each destination row, and
   the per-node totals route back to state order through a second,
   node-sized Clos network (the **state route**);
4. the dangling-mass correction and pre-trust damping
   (``ops.converge.dangling_and_damping``).

A sweep takes one state vector ``[2^state_e]`` or a topic batch
``[K, 2^state_e]`` (``converge_routed_topics``): the batch shares the
operator, and each route stage is one launch whatever K is.

Semantics are those of ``ops.converge.spmv``. The host side (the blocked
bucketization, the operator build, and save/load in the reference's npz
v2, dir v3 and legacy v1 formats) is a copy of the reference's, so one
operator built once serves both packages.

**Layout.** Every large array is 1-D or ``[X, 128]``: a width-w < 128
bucket packs ``g = 128/w`` logical rows per lane-row, and row positions
in the state and z vectors are column-major in the ``[g, X]`` grid.

**Broadcast and reduce without a matmul.** The reference contracts with
constant 0/1 block matrices at ``Precision.HIGHEST``. Here the broadcast
is the row select it encodes (a broadcasting multiply into the edge
array) and the reduce is a segment sum over ``[X, g, w]``, the form the
reference's semiring twins use. No matrix product runs, so TF32 cannot
enter a float32 sweep; the broadcast is bit-identical to the reference's
and the reduce differs only in summation order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graph import filter_edges, stable_argsort_bounded
from ..utils import trace
from .clos import plan_routes, route_core
from .converge import (
    PLUSMUL,
    Semiring,
    adaptive_loop,
    adaptive_loop_topics,
    converge_fixed,
    dangling_and_damping,
    scatter_sum,
    semiring_tail,
)

__all__ = [
    "RoutedOperator",
    "build_routed_operator",
    "ensure_edge_slots",
    "operator_from_numpy",
    "routed_arrays",
    "RoutedStatic",
    "blocked_broadcast",
    "blocked_reduce",
    "spmv_routed",
    "converge_routed_fixed",
    "converge_routed_adaptive",
    "spmv_routed_semiring",
    "converge_routed_fixed_semiring",
    "converge_routed_adaptive_semiring",
    "converge_routed_topics",
]


def _ceil_pow2_exp(x: int, floor: int = 7) -> int:
    e = floor
    while (1 << e) < x:
        e += 1
    return e


def _initial_scores(valid: np.ndarray, initial: float, dtype) -> np.ndarray:
    return (valid * initial).astype(dtype)


def _scores_for_nodes(state_to_node: np.ndarray, n: int,
                      state_scores) -> np.ndarray:
    state_scores = np.asarray(state_scores)
    out = np.zeros(n, dtype=state_scores.dtype)
    live = state_to_node >= 0
    out[state_to_node[live]] = state_scores[live]
    return out


def _scores_from_nodes(state_to_node: np.ndarray, valid: np.ndarray,
                       node_scores, dtype) -> np.ndarray:
    """Inverse of ``_scores_for_nodes``: scatter a node-order vector into
    state-slot order (dead slots stay 0) — the warm-start seam for the
    routed engines (a previous converge's node scores restart the next)."""
    node_scores = np.asarray(node_scores, dtype=np.float64)
    out = np.zeros(len(state_to_node), dtype=np.float64)
    live = state_to_node >= 0
    out[live] = node_scores[state_to_node[live]]
    return (out * valid).astype(dtype)




class _Side(NamedTuple):
    """One blocked ELL side (source or destination).

    widths[b]: logical row width (pow2). xs[b]: physical lane-rows,
    multiple of 8. weight[b]: [X, 128] float64. slot_base[b]: first flat
    slot. pos_base[b]: first row-position in the side's position space
    (state order for the source side, z order for the destination side).
    row_nodes[b]: node id per logical row (length ≤ g·X; pad rows absent).
    row_pos[b]: position of each logical row — column-major in the
    [g, X] grid. edge_slot: flat slot per input edge. n_slots / n_pos:
    totals (pads included).
    """

    widths: tuple
    xs: tuple
    weight: list
    slot_base: tuple
    pos_base: tuple
    row_nodes: list
    row_pos: list
    edge_slot: np.ndarray
    n_slots: int
    n_pos: int


def _bucketize_blocked(n, key, other, weight, min_width=8):
    """Group edges by ``key`` node into blocked pow2-width ELL buckets."""
    order = stable_argsort_bounded(key, n)
    key_s = key[order].astype(np.int64)
    w_s = weight[order]

    deg = np.bincount(key_s, minlength=n).astype(np.int64)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    offset_in_row = np.arange(len(key_s), dtype=np.int64) - ptr[key_s]

    widths_per_row = np.maximum(
        min_width, 2 ** np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
    )
    widths_per_row[deg == 0] = 0
    used = tuple(sorted(int(w) for w in np.unique(widths_per_row) if w > 0))

    widths, xs, wmats, slot_bases, pos_bases = [], [], [], [], []
    row_nodes_l, row_pos_l = [], []
    edge_slot = np.empty(len(key_s), dtype=np.int64)
    slot_base = 0
    pos_base = 0
    for w in used:
        rows = np.nonzero(widths_per_row == w)[0]
        nb = len(rows)
        if w < 128:
            g = 128 // w                 # logical rows per lane-row
            X = -(-nb // g)              # lane-rows…
            X = -(-X // 8) * 8           # …padded to a multiple of 8
            n_pos_b = g * X              # padded grid positions
        else:
            X = nb * (w // 128)
            X = -(-X // 8) * 8
            # X stays divisible by w/128 (either w/128 ≤ 8 and X is a
            # multiple of 8, or nb·w/128 is already a multiple of 8)
            n_pos_b = X * 128 // w       # padded row count

        local = np.full(n, -1, dtype=np.int64)
        local[rows] = np.arange(nb)
        mask = widths_per_row[key_s] == w
        r = local[key_s[mask]]
        off = offset_in_row[mask]
        if w < 128:
            slot = (r // g) * 128 + (r % g) * w + off
            rpos = (np.arange(nb) % g) * X + np.arange(nb) // g
        else:
            slot = r * w + off           # [X, 128] row-major view
            rpos = np.arange(nb)

        wm = np.zeros(X * 128, dtype=np.float64)
        wm[slot] = w_s[mask]
        wmats.append(wm.reshape(X, 128))
        edge_slot[mask] = slot_base + slot

        widths.append(w)
        xs.append(X)
        slot_bases.append(slot_base)
        pos_bases.append(pos_base)
        row_nodes_l.append(rows)
        row_pos_l.append(pos_base + rpos)
        slot_base += X * 128
        pos_base += n_pos_b

    # undo the sort for edge_slot
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return _Side(
        widths=tuple(widths),
        xs=tuple(xs),
        weight=wmats,
        slot_base=tuple(slot_bases),
        pos_base=tuple(pos_bases),
        row_nodes=row_nodes_l,
        row_pos=row_pos_l,
        edge_slot=edge_slot[inv],
        n_slots=slot_base,
        n_pos=pos_base,
    )


def save_operator_npz(op, path) -> None:
    """Field-driven npz serialization shared by the routed operators.

    Every dataclass field is stored under a named, type-tagged key
    (``int_*`` scalar, ``tup_*`` int tuple, ``arr_*`` array,
    ``lst_*_{i}`` list of arrays) — no positional meta vector to
    mis-index. The write is atomic (tmp + rename) so an interrupted run
    can never leave a truncated file under the final name."""
    import dataclasses
    import os

    payload = {"fmt_version": np.asarray(2, dtype=np.int64)}
    for f in dataclasses.fields(op):
        v = getattr(op, f.name)
        if v is None:
            continue  # optional field left unset: loaders default it
        if isinstance(v, (int, np.integer)):
            payload[f"int_{f.name}"] = np.asarray(v, dtype=np.int64)
        elif isinstance(v, tuple):
            payload[f"tup_{f.name}"] = np.asarray(v, dtype=np.int64)
        elif isinstance(v, np.ndarray):
            payload[f"arr_{f.name}"] = v
        elif isinstance(v, list):
            payload[f"cnt_{f.name}"] = np.asarray(len(v), dtype=np.int64)
            for i, a in enumerate(v):
                payload[f"lst_{f.name}_{i}"] = np.asarray(a)
        else:  # pragma: no cover - new field types need a tag here
            raise TypeError(f"unserializable field {f.name}: {type(v)}")
    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as fh:  # file object: savez cannot append
            np.savez(fh, **payload)  # its own .npz suffix to the tmp name
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_operator_dir(op, path) -> None:
    """Directory twin of :func:`save_operator_npz`: one raw ``.npy``
    per array plus a ``meta.json``. No zip container means no CRC32
    pass and no chunked copies on load. Atomic via tmp-dir + rename."""
    import dataclasses
    import json
    import os
    import shutil

    path = str(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(tmp, exist_ok=True)
        meta = {"fmt_version": 3, "ints": {}, "tups": {}, "arrays": [],
                "lists": {}}
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            if v is None:
                continue  # optional field left unset: loaders default it
            if isinstance(v, (int, np.integer)):
                meta["ints"][f.name] = int(v)
            elif isinstance(v, tuple):
                meta["tups"][f.name] = [int(x) for x in v]
            elif isinstance(v, np.ndarray):
                np.save(os.path.join(tmp, f"arr_{f.name}.npy"), v)
                meta["arrays"].append(f.name)
            elif isinstance(v, list):
                meta["lists"][f.name] = len(v)
                for i, a in enumerate(v):
                    np.save(os.path.join(tmp, f"lst_{f.name}_{i}.npy"),
                            np.asarray(a))
            else:  # pragma: no cover - new field types need a tag here
                raise TypeError(
                    f"unserializable field {f.name}: {type(v)}")
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        # swap the old cache out from under the final name, then swap
        # the new one in; if the final rename loses a race, restore the
        # old cache rather than leaking it
        old = f"{path}.old.{os.getpid()}"
        if os.path.isdir(path):
            os.rename(path, old)
        elif os.path.exists(path):
            os.unlink(path)
            old = None
        else:
            old = None
        try:
            os.rename(tmp, path)
        except OSError:
            if old is not None:
                if not os.path.exists(path):
                    try:
                        os.rename(old, path)  # previous cache back
                    except OSError:
                        pass  # surface the original failure below
                else:  # a concurrent writer won the race — drop ours
                    shutil.rmtree(old, ignore_errors=True)
            raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load_operator_dir(cls, path, mmap: bool = True):
    """Inverse of :func:`save_operator_dir`.

    ``mmap=True`` (default) memory-maps every array: the operator is
    usable immediately and its arrays page in once, on demand, while
    they are copied to the device. The maps are read-only;
    ``routed_arrays`` copies before handing them to torch."""
    import dataclasses
    import json
    import os

    mode = "r" if mmap else None
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in meta["ints"]:
            kwargs[f.name] = meta["ints"][f.name]
        elif f.name in meta["tups"]:
            kwargs[f.name] = tuple(meta["tups"][f.name])
        elif f.name in meta["arrays"]:
            kwargs[f.name] = np.load(
                os.path.join(path, f"arr_{f.name}.npy"), mmap_mode=mode)
        elif f.name in meta["lists"]:
            kwargs[f.name] = [
                np.load(os.path.join(path, f"lst_{f.name}_{i}.npy"),
                        mmap_mode=mode)
                for i in range(meta["lists"][f.name])
            ]
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default  # optional field, older cache
        else:
            raise ValueError(f"operator dir is missing field {f.name}")
    return cls(**kwargs)


def load_operator_npz(cls, z):
    """Inverse of :func:`save_operator_npz` for an open npz handle."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(cls):
        if f"int_{f.name}" in z:
            kwargs[f.name] = int(z[f"int_{f.name}"])
        elif f"tup_{f.name}" in z:
            kwargs[f.name] = tuple(int(x) for x in z[f"tup_{f.name}"])
        elif f"arr_{f.name}" in z:
            kwargs[f.name] = z[f"arr_{f.name}"]
        elif f"cnt_{f.name}" in z:
            kwargs[f.name] = [z[f"lst_{f.name}_{i}"]
                              for i in range(int(z[f"cnt_{f.name}"]))]
        elif f.default is not dataclasses.MISSING:
            kwargs[f.name] = f.default  # optional field, older cache
        else:
            raise ValueError(f"operator file is missing field {f.name}")
    return cls(**kwargs)


@dataclass
class RoutedOperator:
    """Host-side routed operator: blocked layouts, masks, route plans."""

    n: int
    n_valid: int
    nnz: int
    out_widths: tuple
    out_xs: tuple
    out_weight: list       # per bucket [X, 128] float64
    n_src_pos: int         # state slots occupied by source rows (pads incl.)
    state_to_node: np.ndarray  # state slot -> node id, -1 for dead slots
    in_widths: tuple
    in_xs: tuple
    in_n_pos: int
    edge_e: int
    edge_bits: tuple
    edge_stages: list
    state_e: int
    state_bits: tuple
    state_stages: list
    valid: np.ndarray      # [2^state_e] f32
    dangling: np.ndarray
    # flat out-side slot per FILTERED edge (the order filter_edges
    # returns — sorted by src*n+dst). The seam the incremental delta
    # engine patches through: slot -> (bucket, lane-row, lane) addresses
    # one value in the out_weight buffers. None on operators built (or
    # cached) before the delta engine existed; ensure_edge_slots
    # upgrades those in O(E) without a plan rebuild.
    out_edge_slot: np.ndarray | None = None
    # the bucket-width floor the build ran with — persisted because the
    # slot math is a function of it: ensure_edge_slots re-deriving
    # slots under a different min_width would scatter patches into the
    # wrong (row, lane) positions. Caches from before this field
    # load as 8 (the only default any cached operator was built with).
    min_width: int = 8

    @property
    def n_state(self) -> int:
        return 1 << self.state_e

    def initial_scores(self, initial: float, dtype=np.float32) -> np.ndarray:
        return _initial_scores(self.valid, initial, dtype)

    def scores_for_nodes(self, state_scores: np.ndarray) -> np.ndarray:
        """Translate a state-order score vector to node order."""
        return _scores_for_nodes(self.state_to_node, self.n, state_scores)

    def scores_from_nodes(self, node_scores: np.ndarray,
                          dtype=np.float32) -> np.ndarray:
        """Translate a node-order score vector to state order (warm start)."""
        return _scores_from_nodes(self.state_to_node, self.valid,
                                  node_scores, dtype)

    def save(self, path) -> None:
        """Persist the compiled operator so the one-time routing-plan
        compilation is reusable across runs. A path WITHOUT an ``.npz``
        suffix uses the raw-directory format (faster loads);
        ``.npz`` keeps the legacy container. Weights stay float64: the
        f64 converge path must round-trip losslessly."""
        if str(path).endswith(".npz"):
            save_operator_npz(self, path)
        else:
            save_operator_dir(self, path)

    @classmethod
    def load(cls, path) -> "RoutedOperator":
        import os

        if os.path.isdir(path):
            return load_operator_dir(cls, path)
        with np.load(path) as z:
            if "fmt_version" in z:
                return load_operator_npz(cls, z)
            # legacy v1 format (positional meta vector), kept readable so
            # pre-existing operator caches stay valid
            meta = z["meta"]
            out_widths = tuple(int(w) for w in z["out_widths"])
            return cls(
                n=int(meta[0]),
                n_valid=int(meta[1]),
                nnz=int(meta[2]),
                out_widths=out_widths,
                out_xs=tuple(int(x) for x in z["out_xs"]),
                out_weight=[z[f"out_weight_{i}"]
                            for i in range(len(out_widths))],
                n_src_pos=int(meta[3]),
                state_to_node=z["state_to_node"],
                in_widths=tuple(int(w) for w in z["in_widths"]),
                in_xs=tuple(int(x) for x in z["in_xs"]),
                in_n_pos=int(meta[6]),
                edge_e=int(meta[4]),
                edge_bits=tuple(int(b) for b in z["edge_bits"]),
                edge_stages=list(z["edge_stages"]),
                state_e=int(meta[5]),
                state_bits=tuple(int(b) for b in z["state_bits"]),
                state_stages=list(z["state_stages"]),
                valid=z["valid"],
                dangling=z["dangling"],
            )


def build_routed_operator(
    n, src, dst, val, valid=None, min_width: int = 8,
    prefer_native: bool = True,
) -> RoutedOperator:
    """Filter + normalize an edge list and compile the routing program:
    the converge path's one-time host cost (the plan build dominates).

    Semantics of ``filter_edges`` (the reference's opinion filter) are
    shared with the gather path; the result is field for field the
    reference's ``build_routed_operator`` output. Every build counts
    one ``ptpu_operator_full_builds_total`` (the cost the delta engine
    exists to avoid: a churn window must leave it flat) and runs under
    the ``routed.plan_build`` span, timed as
    ``ptpu_routed_plan_build_seconds``."""
    trace.counter("operator_full_builds").inc()
    with trace.timed("routed_plan_build_seconds", "routed.plan_build",
                     n=n, edges=len(src)):
        return _build_routed_operator(n, src, dst, val, valid, min_width,
                                      prefer_native)


def ensure_edge_slots(op: RoutedOperator, src, dst, weight) \
        -> RoutedOperator:
    """Upgrade a pre-delta-engine operator (cached without
    ``out_edge_slot``) in place: recompute the out-side bucketization —
    O(E) numpy, NO routing-plan rebuild — for the same filtered edge
    arrays the operator was built from. Deterministic: the slot math is
    the exact ``_bucketize_blocked`` pass the build ran, under the
    ``min_width`` the operator persists."""
    if op.out_edge_slot is None:
        op.out_edge_slot = _bucketize_blocked(
            n=op.n, key=np.asarray(src), other=np.asarray(dst),
            weight=np.asarray(weight), min_width=op.min_width).edge_slot
    return op


def _build_routed_operator(
    n, src, dst, val, valid, min_width: int, prefer_native: bool,
) -> RoutedOperator:
    src, dst, weight, valid_mask, dangling = filter_edges(n, src, dst, val, valid)

    # the two sides bucketize independently: overlap them on threads
    # (numpy's big sorts release the GIL), like the two plan builds below
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        out_f = pool.submit(_bucketize_blocked, n, src, dst, weight,
                            min_width)
        in_f = pool.submit(_bucketize_blocked, n, dst, src, weight,
                           min_width)
        out_side, in_side = out_f.result(), in_f.result()

    # state order: source-row positions first (column-major grids, dead
    # pad slots included), then out-edge-less nodes
    n_src_pos = out_side.n_pos
    src_pos = (np.concatenate(out_side.row_pos) if out_side.row_pos
               else np.zeros(0, dtype=np.int64))
    src_nodes = (np.concatenate(out_side.row_nodes) if out_side.row_nodes
                 else np.zeros(0, dtype=np.int64))
    has_out = np.zeros(n, dtype=bool)
    has_out[src_nodes] = True
    rest = np.nonzero(~has_out)[0]

    state_e = _ceil_pow2_exp(max(n_src_pos + len(rest), in_side.n_pos, 128))
    N2 = 1 << state_e
    state_to_node = np.full(N2, -1, dtype=np.int64)
    state_to_node[src_pos] = src_nodes
    state_to_node[n_src_pos : n_src_pos + len(rest)] = rest
    node_to_state = np.full(n, -1, dtype=np.int64)
    live = state_to_node >= 0
    node_to_state[state_to_node[live]] = np.nonzero(live)[0]

    # --- edge route: in slot <- out slot ---------------------------------
    # int32 throughout: these are 2^28-sized working arrays at 10M-peer
    # scale — int64 doubles their alloc + scatter traffic for slot ids
    # that fit 31 bits by construction (edge_e ≤ 31)
    edge_e = _ceil_pow2_exp(max(out_side.n_slots, in_side.n_slots, 128))
    E2 = 1 << edge_e
    assert edge_e <= 31, "edge slot space exceeds int32 (scale the " \
        "assembly dtypes before routing this graph)"
    perm = np.full(E2, -1, dtype=np.int32)
    perm[in_side.edge_slot] = out_side.edge_slot
    src_used = np.zeros(E2, dtype=bool)
    src_used[out_side.edge_slot] = True
    free_src = np.nonzero(~src_used)[0]   # out-ELL pads + tail: all zeros
    need = np.nonzero(perm < 0)[0]        # in-ELL pads + tail
    perm[need] = free_src[: len(need)]

    # --- state route: state slot <- z position ---------------------------
    # z = concatenated per-bucket in-row sums (column-major positions)
    in_nodes = (np.concatenate(in_side.row_nodes) if in_side.row_nodes
                else np.zeros(0, dtype=np.int64))
    in_pos = (np.concatenate(in_side.row_pos) if in_side.row_pos
              else np.zeros(0, dtype=np.int64))
    node_in_pos = np.full(n, -1, dtype=np.int64)
    node_in_pos[in_nodes] = in_pos
    assert state_e <= 31, "state slot space exceeds int32 (scale the " \
        "assembly dtypes before routing this graph)"
    sperm = np.full(N2, -1, dtype=np.int32)
    live_nodes = state_to_node[live]
    live_slots = np.nonzero(live)[0]
    with_in = node_in_pos[live_nodes] >= 0
    sperm[live_slots[with_in]] = node_in_pos[live_nodes[with_in]]
    sp_used = np.zeros(N2, dtype=bool)
    sp_used[sperm[sperm >= 0]] = True
    free_zero = np.nonzero(~sp_used)[0]   # z pads + tail: all zeros
    need = np.nonzero(sperm < 0)[0]
    sperm[need] = free_zero[: len(need)]
    # both plans at once: the state plan (2^state_e, typically 16x
    # smaller) rides in the edge plan's shadow — the threaded plan
    # build is the DEFAULT full-rebuild fast path
    plan, splan = plan_routes((perm, sperm), prefer_native=prefer_native)

    valid_state = np.zeros(N2, dtype=np.float32)
    valid_state[live_slots] = valid_mask[live_nodes].astype(np.float32)
    dangling_state = np.zeros(N2, dtype=np.float32)
    dangling_state[live_slots] = dangling[live_nodes].astype(np.float32)

    return RoutedOperator(
        n=n,
        n_valid=int(valid_mask.sum()),
        nnz=len(src),
        out_widths=out_side.widths,
        out_xs=out_side.xs,
        out_weight=out_side.weight,
        n_src_pos=n_src_pos,
        state_to_node=state_to_node,
        in_widths=in_side.widths,
        in_xs=in_side.xs,
        in_n_pos=in_side.n_pos,
        edge_e=plan.e,
        edge_bits=plan.bits,
        edge_stages=plan.stages,
        state_e=splan.e,
        state_bits=splan.bits,
        state_stages=splan.stages,
        valid=valid_state,
        dangling=dangling_state,
        out_edge_slot=out_side.edge_slot,
        min_width=min_width,
    )


def operator_from_numpy(fields: dict) -> RoutedOperator:
    """A ``RoutedOperator`` from another package's operator fields (the
    reference's ``dataclasses`` fields, as numpy arrays, ints, tuples and
    lists of arrays): the compiled operator carried across without a
    rebuild. Optional fields may be absent."""
    kwargs = {}
    for f in dataclasses.fields(RoutedOperator):
        if f.name not in fields:
            if f.default is dataclasses.MISSING:
                raise ValueError(f"operator fields lack {f.name}")
            continue
        v = fields[f.name]
        if v is None:
            kwargs[f.name] = None
        elif f.type == "int":
            kwargs[f.name] = int(v)
        elif f.type == "tuple":
            kwargs[f.name] = tuple(int(x) for x in v)
        elif f.type == "list":
            kwargs[f.name] = [np.asarray(a) for a in v]
        else:
            kwargs[f.name] = np.asarray(v)
    return RoutedOperator(**kwargs)


class RoutedStatic(NamedTuple):
    """Shape configuration of a routed operator's sweep."""

    out_widths: tuple
    out_xs: tuple
    in_widths: tuple
    in_xs: tuple
    in_n_pos: int
    edge_e: int
    edge_bits: tuple
    state_e: int
    state_bits: tuple


def _to_device(a, dtype, device) -> torch.Tensor:
    # writable C copy when needed (loaded operators may be read-only maps)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    host = np.require(a, dtype=np_dtype, requirements=["C", "W"])
    return torch.from_numpy(host).to(device)


def routed_arrays(op: RoutedOperator, dtype=torch.float32, alpha: float = 0.0,
                  pretrust=None, device=None):
    """Device tensors + static config of a routed operator. ``alpha`` as
    in ``ops.converge.operator_arrays``. ``pretrust`` must be in **state
    order** with length ``2^state_e`` (zero on dead slots); the default is
    uniform over valid peers. Route stages stay uint8 on the device."""
    device = resolve_device(device)
    if pretrust is None:
        pretrust = op.valid.astype(np.float64) / max(op.n_valid, 1)

    def scalar(v):
        return torch.tensor(float(v), dtype=dtype, device=device)

    arrs = {
        "out_weight": tuple(_to_device(w, dtype, device)
                            for w in op.out_weight),
        "edge_stages": tuple(_to_device(s, torch.uint8, device)
                             for s in op.edge_stages),
        "state_stages": tuple(_to_device(s, torch.uint8, device)
                              for s in op.state_stages),
        "valid": _to_device(op.valid, dtype, device),
        "dangling": _to_device(op.dangling, dtype, device),
        "n_valid": scalar(op.n_valid),
        "alpha": scalar(alpha),
        "pretrust": _to_device(pretrust, dtype, device),
    }
    static = RoutedStatic(
        out_widths=op.out_widths,
        out_xs=op.out_xs,
        in_widths=op.in_widths,
        in_xs=op.in_xs,
        in_n_pos=op.in_n_pos,
        edge_e=op.edge_e,
        edge_bits=op.edge_bits,
        state_e=op.state_e,
        state_bits=op.state_bits,
    )
    return arrs, static


def blocked_broadcast(arrs: dict, s: torch.Tensor, widths: tuple, xs: tuple,
                      total_len: int, sr: Semiring = PLUSMUL) -> torch.Tensor:
    """Expand a state vector (or a ``[K, ·]`` batch of them) into
    ``sr.mul``-combined edge values across the blocked buckets (the
    source side of the routed SpMV). For w < 128, lane ``l`` of lane-row
    ``x`` takes grid row ``l // w``, whose score sits at state position
    ``(l // w)·X + x``; for w ≥ 128 a row spans ``w/128`` whole
    lane-rows. Pad lanes carry weight 0, so they yield ``sr.zero``; the
    tail past the buckets is filled with it."""
    lead = s.shape[:-1]
    out = s.new_empty(lead + (total_len,))
    pos = 0
    off = 0
    for bi, (w, X) in enumerate(zip(widths, xs)):
        w_mat = arrs["out_weight"][bi]
        dst = out[..., off: off + X * 128]
        if w < 128:
            g = 128 // w
            s2t = s[..., pos: pos + g * X].unflatten(-1, (g, X))
            sr.mul(s2t.transpose(-1, -2).unsqueeze(-1),
                   w_mat.view(X, g, w), out=dst.unflatten(-1, (X, g, w)))
            pos += g * X
        else:
            nb_pad = X * 128 // w        # padded row count
            sr.mul(s[..., pos: pos + nb_pad].unsqueeze(-1),
                   w_mat.view(nb_pad, w),
                   out=dst.unflatten(-1, (nb_pad, w)))
            pos += nb_pad
        off += X * 128
    out[..., off:].fill_(sr.zero)
    return out


def blocked_reduce(arrs: dict, y: torch.Tensor, widths: tuple, xs: tuple,
                   n_pos: int, total_len: int,
                   sr: Semiring = PLUSMUL) -> torch.Tensor:
    """Lane-segmented per-row ``sr.reduce`` of a routed edge array, or a
    ``[K, ·]`` batch of them (the destination side). For w < 128 logical
    row ``r`` (lane-row ``x = r // g``, sub-row ``b = r % g``) owns lanes
    ``[b·w, (b+1)·w)`` and its sum lands at z position ``b·X + x``."""
    lead = y.shape[:-1]
    sums = []
    off = 0
    for w, X in zip(widths, xs):
        y2 = y[..., off: off + X * 128]
        if w < 128:
            g = 128 // w
            sums.append(sr.reduce(y2.unflatten(-1, (X, g, w)), dim=-1)
                        .transpose(-1, -2).flatten(-2))
        else:
            nb_pad = X * 128 // w
            sums.append(sr.reduce(
                sr.reduce(y2.unflatten(-1, (X, 128)), dim=-1)
                .unflatten(-1, (nb_pad, w // 128)), dim=-1))
        off += X * 128
    sums.append(y.new_full(lead + (total_len - n_pos,), sr.zero))
    return torch.cat(sums, dim=-1)


def spmv_routed(arrs: dict, static: RoutedStatic,
                s: torch.Tensor) -> torch.Tensor:
    """One application of the normalized trust operator (state order,
    ``s`` of ``[2^state_e]`` or ``[K, 2^state_e]``): broadcast → edge
    route → reduce → state route → dangling + damping.

    Two optional keys make it the delta engine's patched matvec:

    - ``inv_row_scale`` ([2^state_e]): per-source-row normalization
      correction applied to the source score (weights store
      ``val / row_sum_at_build``);
    - ``tail_src``/``tail_dst``/``tail_w`` (int64 indices, state order):
      a fixed-capacity COO of structural inserts with true normalized
      weights, folded in with one ``scatter_sum`` (the same bits on
      every run).
    """
    s_b = s * arrs["inv_row_scale"] if "inv_row_scale" in arrs else s
    x = blocked_broadcast(arrs, s_b, static.out_widths, static.out_xs,
                          1 << static.edge_e)
    y = route_core(x, arrs["edge_stages"], 0, static.edge_e,
                   static.edge_bits)
    z = blocked_reduce(arrs, y, static.in_widths, static.in_xs,
                       static.in_n_pos, 1 << static.state_e)
    base = route_core(z, arrs["state_stages"], 0, static.state_e,
                      static.state_bits)
    if "tail_w" in arrs:
        # tail weights are TRUE normalized weights: no inv_row_scale
        # (the engine's sweep: one vector, never a topic batch)
        base = base + scatter_sum(arrs["tail_w"] * s[arrs["tail_src"]],
                                  arrs["tail_dst"], base.shape[-1])
    return dangling_and_damping(arrs, s, base)


def converge_routed_fixed(arrs: dict, static: RoutedStatic, s0,
                          num_iterations: int):
    """Reference-parity fixed-iteration power iteration, routed."""
    return converge_fixed(lambda s: spmv_routed(arrs, static, s), s0,
                          num_iterations)


def converge_routed_adaptive(arrs: dict, static: RoutedStatic, s0,
                             tol: float = 1e-6, max_iterations: int = 100,
                             accel_every: int = 0):
    """Iterate until the relative L1 delta ≤ tol (or max_iterations);
    ``accel_every`` as in ``ops.converge.adaptive_loop``. Returns
    (scores, iterations_run, final_relative_delta)."""
    return adaptive_loop(lambda s: spmv_routed(arrs, static, s), s0, tol,
                         max_iterations, accel_every)


def spmv_routed_semiring(arrs: dict, static: RoutedStatic, s,
                         sr: Semiring) -> torch.Tensor:
    """One generalized sweep through the same compiled operator: the
    routes are permutations, so only broadcast and reduce change with
    the algebra. (+,×) is exactly :func:`spmv_routed`."""
    if sr.name == "plusmul":
        return spmv_routed(arrs, static, s)
    x = blocked_broadcast(arrs, s, static.out_widths, static.out_xs,
                          1 << static.edge_e, sr)
    y = route_core(x, arrs["edge_stages"], 0, static.edge_e,
                   static.edge_bits)
    z = blocked_reduce(arrs, y, static.in_widths, static.in_xs,
                       static.in_n_pos, 1 << static.state_e, sr)
    base = route_core(z, arrs["state_stages"], 0, static.state_e,
                      static.state_bits)
    return semiring_tail(sr, arrs, s, base)


def converge_routed_fixed_semiring(arrs: dict, static: RoutedStatic, s0,
                                   sr: Semiring, num_iterations: int):
    return converge_fixed(
        lambda s: spmv_routed_semiring(arrs, static, s, sr), s0,
        num_iterations)


def converge_routed_adaptive_semiring(arrs: dict, static: RoutedStatic, s0,
                                      sr: Semiring, tol: float = 1e-6,
                                      max_iterations: int = 100,
                                      accel_every: int = 0):
    """Adaptive routed converge under a pluggable semiring. Returns
    (scores, iterations_run, final_relative_delta)."""
    return adaptive_loop(
        lambda s: spmv_routed_semiring(arrs, static, s, sr), s0, tol,
        max_iterations, accel_every)


def converge_routed_topics(arrs: dict, static: RoutedStatic, s0k,
                           sr: Semiring, tol: float = 1e-6,
                           max_iterations: int = 100):
    """Topic-batched adaptive converge through one routed operator: K
    state-order topic vectors ``s0k[K, 2^state_e]`` swept together, so
    the routing-plan build is paid once for all K and each route stage
    is one launch for the whole batch. Each topic's trajectory is its
    own (``ops.converge.adaptive_loop_topics``: a converged topic is
    frozen). Returns ``(scores[K, ·], iters[K], delta[K])``."""
    return adaptive_loop_topics(
        lambda s: spmv_routed_semiring(arrs, static, s, sr), s0k, tol,
        max_iterations)
