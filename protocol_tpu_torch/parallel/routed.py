"""Sharded Clos-routed convergence: the permutation-network SpMV over a
device mesh, the counterpart of ``protocol_tpu/parallel/routed.py``.

Where ``parallel.converge`` all-gathers the score vector and runs the
gather SpMV per shard, this module shards the *routed* SpMV
(``ops.routed``): every lane-permutation stage of the Clos network is
row-local to a shard, and only the level-0 perfect shuffle spans the
mesh — one ``all_to_all`` forward and one back per route. Shards own
complete middle subnetworks (shard d holds subnetworks
[d·128/D, (d+1)·128/D)), so every deeper level, the base, and the
bucket broadcast/reduce around the route are shard-local. Per iteration
the exchanges are 2 all-to-alls of the edge array, 2 of the state
vector, and O(1) psum scalars — no all-gather of scores at all.

Layout: global slot/state spaces are **device-major** — shard d owns the
contiguous slot range [d·E2/D, (d+1)·E2/D) holding its buckets'
``[X, 128]`` blocks plus local zero padding, and likewise a contiguous
state slice. The route plans are computed over these global spaces by
the same planner as the single-device path (``ops.clos.plan_route``,
the C++ ``csrc/clos_plan.cpp`` when built): it routes whatever
permutation the layout induces, and the per-stage index arrays split
into per-shard slices that stay aligned with shard ownership through
every stage. The host build is a copy of the reference's.

Kernels: every stage runs the route-stage kernel (B1,
``ops/kernels``) on its shard. The single-device route fuses each
interior level's transpose into that level's launch; here the level-0
transpose *is* the cross-mesh shuffle, so the level-0 input and output
permutations run as middle-form launches (``lane_perm``) with the
``all_to_all`` and the shard-local transposes (torch copies) between
them, and the middle levels run through ``route_core`` batched over the
shard's 128/D subnetworks. A route over ``len(bits)`` levels is
``2·len(bits) − 1`` launches per shard either way, so a sweep launches
B1 ``D · (len(edge_stages) + len(state_stages))`` times
(:func:`lane_perm_launches_per_sweep`).

Constraints: the mesh size D must divide 128 (subnetwork ownership),
and the padded slot/state spaces are sized so each shard's row count is
a multiple of 8.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph import filter_edges
from ..ops.clos import plan_routes, route_core
from ..ops.converge import timed_converge
from ..ops.kernels import lane_perm
from ..ops.routed import (
    _bucketize_blocked,
    _ceil_pow2_exp,
    _initial_scores,
    _scores_for_nodes,
    _scores_from_nodes,
    _to_device,
    blocked_broadcast,
    blocked_reduce,
    load_operator_npz,
    save_operator_npz,
)
from .converge import (
    _check_shards,
    as_tensor,
    mesh_adaptive_loop,
    psum_dangling_and_damping,
)
from .mesh import Mesh, all_to_all, shard, unshard

__all__ = [
    "ShardedRoutedOperator",
    "build_sharded_routed_operator",
    "lane_perm_launches_per_sweep",
    "place_sharded_routed",
    "sharded_apply_route",
    "sharded_routed_converge_fixed",
    "sharded_routed_converge_adaptive",
]


def sharded_apply_route(xs: list, stages: list, e: int, bits: tuple,
                        mesh: Mesh) -> list:
    """A route over the mesh. ``xs[d]``: shard d's contiguous slot slice
    (2^e / D elements); ``stages[d]``: its slices of the stage arrays."""
    D = mesh.size
    if D == 1 or len(bits) == 1:
        return [route_core(x, st, 0, e, bits) for x, st in zip(xs, stages)]
    E_loc = (1 << e) // D
    m = 1 << (e - 7)

    # level-0 input lane permutation (row-local): [m/D, 128] per shard
    xs = [lane_perm(x.view(-1, 128), st[0].view(-1, 128))
          for x, st in zip(xs, stages)]
    # perfect shuffle across the mesh: [m, 128] -> [128, m], sharded
    xs = all_to_all(xs, mesh, split_dim=1, concat_dim=0)     # [m, 128/D]
    xs = [x.t().reshape(E_loc) for x in xs]  # the shard's subnetworks

    # middle levels: batched over the shard's subnetworks, local
    xs = [route_core(x, st, 1, e - 7, bits[1:])
          for x, st in zip(xs, stages)]

    # inverse shuffle
    xs = [x.view(128 // D, m).t() for x in xs]               # [m, 128/D]
    xs = all_to_all(xs, mesh, split_dim=0, concat_dim=1)     # [m/D, 128]
    # level-0 output lane permutation
    return [lane_perm(x, st[-1].view(-1, 128)).view(E_loc)
            for x, st in zip(xs, stages)]


@dataclass
class ShardedRoutedOperator:
    """Per-device blocked layouts + global route plans, device-major."""

    n: int
    n_valid: int
    nnz: int
    num_shards: int
    # uniform per-device bucket geometry
    out_widths: tuple
    out_xs: tuple             # per bucket: lane-rows per device
    out_weight: list          # per bucket: [D, X, 128] float64
    in_widths: tuple
    in_xs: tuple
    in_n_pos: int             # per-device z positions (pads included)
    n_state_local: int        # per-device state slice length (N2 // D)
    state_to_node: np.ndarray  # [N2] global state slot -> node id (-1 dead)
    edge_e: int
    edge_bits: tuple
    edge_stages: list         # flat uint8 [E2] each
    state_e: int
    state_bits: tuple
    state_stages: list
    valid: np.ndarray         # [N2] f32, device-major state order
    dangling: np.ndarray

    @property
    def n_state(self) -> int:
        return 1 << self.state_e

    def initial_scores(self, initial: float, dtype=np.float32) -> np.ndarray:
        return _initial_scores(self.valid, initial, dtype)

    def scores_for_nodes(self, state_scores) -> np.ndarray:
        if isinstance(state_scores, torch.Tensor):
            state_scores = state_scores.cpu().numpy()
        return _scores_for_nodes(self.state_to_node, self.n, state_scores)

    def scores_from_nodes(self, node_scores: np.ndarray,
                          dtype=np.float32) -> np.ndarray:
        """Node-order vector → device-major state order (warm start)."""
        return _scores_from_nodes(self.state_to_node, self.valid,
                                  node_scores, dtype)

    def save(self, path) -> None:
        """Persist the compiled device-major operator (uncompressed .npz,
        atomic) so the one-time routing-plan compilation is reusable
        across runs; the reference's file format. The layout is
        D-specific: ``load`` refuses a different shard count rather than
        silently permuting scores."""
        save_operator_npz(self, path)

    @classmethod
    def load(cls, path, num_shards=None) -> "ShardedRoutedOperator":
        with np.load(path) as z:
            op = load_operator_npz(cls, z)
        if num_shards is not None and op.num_shards != num_shards:
            raise ValueError(
                f"cached operator was compiled for "
                f"num_shards={op.num_shards}, requested {num_shards}")
        return op

    def device_arrays(self, mesh: Mesh, dtype=torch.float32,
                      alpha: float = 0.0, pretrust=None) -> list:
        """One dict of tensors per shard, on that shard's device; route
        stages stay uint8. ``pretrust`` is in state order."""
        D = self.num_shards
        if pretrust is None:
            pretrust = self.valid.astype(np.float64) / max(self.n_valid, 1)
        pretrust = np.asarray(pretrust).reshape(D, -1)
        valid = self.valid.reshape(D, -1)
        dangling = self.dangling.reshape(D, -1)
        edge = [s.reshape(D, -1) for s in self.edge_stages]
        state = [s.reshape(D, -1) for s in self.state_stages]
        return [{
            "out_weight": tuple(_to_device(w[d], dtype, dev)
                                for w in self.out_weight),
            "edge_stages": tuple(_to_device(s[d], torch.uint8, dev)
                                 for s in edge),
            "state_stages": tuple(_to_device(s[d], torch.uint8, dev)
                                  for s in state),
            "valid": _to_device(valid[d], dtype, dev),
            "dangling": _to_device(dangling[d], dtype, dev),
            "pretrust": _to_device(pretrust[d], dtype, dev),
            "alpha": torch.tensor(float(alpha), dtype=dtype, device=dev),
        } for d, dev in enumerate(mesh.devices)]


def lane_perm_launches_per_sweep(op: ShardedRoutedOperator) -> int:
    """B1 launches of one sharded sweep: every shard runs each route's
    ``2·len(bits) − 1`` stages, the level-0 ones as middle-form
    launches."""
    return op.num_shards * (len(op.edge_stages) + len(op.state_stages))


def build_sharded_routed_operator(
    n, src, dst, val, valid=None, num_shards: int = 1, min_width: int = 8,
    prefer_native: bool = True,
) -> ShardedRoutedOperator:
    """Filter + normalize an edge list and compile a device-major routing
    program for ``num_shards`` devices (must divide 128)."""
    D = num_shards
    if D < 1 or 128 % D:
        raise ValueError(f"num_shards must divide 128, got {D}")
    src, dst, weight, valid_mask, dangling = filter_edges(
        n, src, dst, val, valid)

    # nodes striped across devices by id; per-device blocked sides
    out_sides, in_sides = [], []
    for d in range(D):
        m_out = (src % D) == d
        out_sides.append(_bucketize_blocked(
            n, src[m_out], dst[m_out], weight[m_out], min_width))
        m_in = (dst % D) == d
        in_sides.append(_bucketize_blocked(
            n, dst[m_in], src[m_in], weight[m_in], min_width))

    def unify(sides):
        """Common width set + per-width max X across devices."""
        widths = sorted({w for s in sides for w in s.widths})
        xs = []
        for w in widths:
            xs.append(max(
                (s.xs[s.widths.index(w)] if w in s.widths else 0)
                for s in sides))
        # every device's X must be a multiple of 8 already; keep max
        return tuple(widths), tuple(int(x) for x in xs)

    out_widths, out_xs = unify(out_sides)
    in_widths, in_xs = unify(in_sides)
    out_slots_dev = sum(x * 128 for x in out_xs)
    in_slots_dev = sum(x * 128 for x in in_xs)

    # global edge-slot space: device-major, 2^edge_e total. Each device's
    # slice must hold its buckets and split into ≥8 lane-rows, and the
    # level-0 row space m = E2/128 must divide by D.
    floor_e = max(7, 10 + (D - 1).bit_length())
    edge_e = _ceil_pow2_exp(max(out_slots_dev, in_slots_dev, 1) * D, floor_e)

    def side_slots(sides, widths, xs, base_of_dev):
        """Map every edge to its global slot under the unified geometry."""
        slots = []
        for d, s in enumerate(sides):
            # bucket base offsets under unified geometry
            base = {}
            off = 0
            for w, X in zip(widths, xs):
                base[w] = off
                off += X * 128
            # remap this device's local slots bucket-by-bucket
            loc = np.asarray(s.edge_slot)
            out = np.empty(len(loc), dtype=np.int64)
            for w, sb, X_d in zip(s.widths, s.slot_base, s.xs):
                nsl = X_d * 128
                m = (loc >= sb) & (loc < sb + nsl)
                out[m] = base_of_dev(d) + base[w] + (loc[m] - sb)
            slots.append(out)
        return slots

    E2 = 1 << edge_e
    dev_stride = E2 // D
    out_slot_l = side_slots(out_sides, out_widths, out_xs,
                            lambda d: d * dev_stride)
    in_slot_l = side_slots(in_sides, in_widths, in_xs,
                           lambda d: d * dev_stride)

    # weights under unified geometry
    out_weight = []
    for w, X in zip(out_widths, out_xs):
        wm = np.zeros((D, X, 128), dtype=np.float64)
        for d, s in enumerate(out_sides):
            if w in s.widths:
                bi = s.widths.index(w)
                wm[d, : s.xs[bi]] = s.weight[bi]
        out_weight.append(wm)

    # per-device state layout: out-side positions (unified geometry),
    # then the device's out-edge-less nodes, then padding
    def unified_pos(sides, widths, xs):
        """Per device: node ids and their positions under unified bases."""
        pos_base = {}
        off = 0
        for w, X in zip(widths, xs):
            pos_base[w] = off
            off += (128 // w) * X if w < 128 else X * 128 // w
        n_pos_dev = off
        out = []
        for s in sides:
            nodes_l, pos_l = [], []
            for bi, w in enumerate(s.widths):
                X_d = s.xs[bi]
                rp = s.row_pos[bi] - s.pos_base[bi]  # local grid position
                if w < 128:
                    # re-express column-major position under unified X
                    i, x = rp // X_d, rp % X_d
                    rp = i * xs[widths.index(w)] + x
                nodes_l.append(s.row_nodes[bi])
                pos_l.append(pos_base[w] + rp)
            out.append((np.concatenate(nodes_l) if nodes_l else
                        np.zeros(0, dtype=np.int64),
                        np.concatenate(pos_l) if pos_l else
                        np.zeros(0, dtype=np.int64)))
        return out, n_pos_dev

    out_np, out_pos_dev = unified_pos(out_sides, out_widths, out_xs)
    in_np, in_pos_dev = unified_pos(in_sides, in_widths, in_xs)

    has_out = np.zeros(n, dtype=bool)
    for nodes, _ in out_np:
        has_out[nodes] = True
    rest_per_dev = [np.nonzero((~has_out)
                               & ((np.arange(n) % D) == d))[0]
                    for d in range(D)]
    state_need = max(out_pos_dev + max(len(r) for r in rest_per_dev),
                     in_pos_dev, 1)
    state_e = _ceil_pow2_exp(state_need * D, floor_e)
    N2 = 1 << state_e
    s_stride = N2 // D

    state_to_node = np.full(N2, -1, dtype=np.int64)
    for d in range(D):
        nodes, pos = out_np[d]
        state_to_node[d * s_stride + pos] = nodes
        r = rest_per_dev[d]
        state_to_node[d * s_stride + out_pos_dev:
                      d * s_stride + out_pos_dev + len(r)] = r

    # --- edge route ------------------------------------------------------
    perm = np.full(E2, -1, dtype=np.int64)
    all_in = np.concatenate(in_slot_l) if in_slot_l else np.zeros(0, np.int64)
    all_out = (np.concatenate(out_slot_l) if out_slot_l
               else np.zeros(0, np.int64))
    # both sides enumerate the SAME filtered edges, each in its own
    # device-subset order — align through global edge ids
    eid = np.arange(len(src))
    out_eid = np.concatenate([eid[(src % D) == d] for d in range(D)])
    in_eid = np.concatenate([eid[(dst % D) == d] for d in range(D)])
    out_slot_of_eid = np.empty(len(src), dtype=np.int64)
    out_slot_of_eid[out_eid] = all_out
    perm[all_in] = out_slot_of_eid[in_eid]

    src_used = np.zeros(E2, dtype=bool)
    src_used[all_out] = True
    free_src = np.nonzero(~src_used)[0]
    need = np.nonzero(perm < 0)[0]
    perm[need] = free_src[: len(need)]

    # --- state route -----------------------------------------------------
    node_in_pos = np.full(n, -1, dtype=np.int64)
    for d in range(D):
        nodes, pos = in_np[d]
        node_in_pos[nodes] = d * s_stride + pos
    sperm = np.full(N2, -1, dtype=np.int64)
    live = state_to_node >= 0
    live_slots = np.nonzero(live)[0]
    live_nodes = state_to_node[live_slots]
    with_in = node_in_pos[live_nodes] >= 0
    sperm[live_slots[with_in]] = node_in_pos[live_nodes[with_in]]
    sp_used = np.zeros(N2, dtype=bool)
    sp_used[sperm[sperm >= 0]] = True
    free_zero = np.nonzero(~sp_used)[0]
    need = np.nonzero(sperm < 0)[0]
    sperm[need] = free_zero[: len(need)]

    # the two plans overlap on host threads (the same bytes as one by one)
    plan, splan = plan_routes([perm.astype(np.int32), sperm.astype(np.int32)],
                              prefer_native=prefer_native)

    valid_state = np.zeros(N2, dtype=np.float32)
    valid_state[live_slots] = valid_mask[live_nodes].astype(np.float32)
    dangling_state = np.zeros(N2, dtype=np.float32)
    dangling_state[live_slots] = dangling[live_nodes].astype(np.float32)

    return ShardedRoutedOperator(
        n=n,
        n_valid=int(valid_mask.sum()),
        nnz=len(src),
        num_shards=D,
        out_widths=out_widths,
        out_xs=out_xs,
        out_weight=out_weight,
        in_widths=in_widths,
        in_xs=in_xs,
        in_n_pos=in_pos_dev,
        n_state_local=s_stride,
        state_to_node=state_to_node,
        edge_e=plan.e,
        edge_bits=plan.bits,
        edge_stages=plan.stages,
        state_e=splan.e,
        state_bits=splan.bits,
        state_stages=splan.stages,
        valid=valid_state,
        dangling=dangling_state,
    )


def sharded_routed_spmv(arrs: list, s_blocks: list,
                        op: ShardedRoutedOperator, mesh: Mesh) -> list:
    """One sharded routed sweep: per-shard broadcast, the edge route over
    the mesh, per-shard reduce, the state route, the psum'd tail."""
    D = op.num_shards
    xs = [blocked_broadcast(a, s, op.out_widths, op.out_xs,
                            (1 << op.edge_e) // D)
          for a, s in zip(arrs, s_blocks)]
    ys = sharded_apply_route(xs, [a["edge_stages"] for a in arrs],
                             op.edge_e, op.edge_bits, mesh)
    zs = [blocked_reduce(a, y, op.in_widths, op.in_xs, op.in_n_pos,
                         (1 << op.state_e) // D)
          for a, y in zip(arrs, ys)]
    bases = sharded_apply_route(zs, [a["state_stages"] for a in arrs],
                                op.state_e, op.state_bits, mesh)
    return psum_dangling_and_damping(arrs, s_blocks, bases,
                                     float(op.n_valid), mesh)


def place_sharded_routed(op: ShardedRoutedOperator, mesh: Mesh,
                         dtype=torch.float32, alpha: float = 0.0) -> list:
    """Build the per-shard tensors ONCE and place them on the mesh.
    Callers that converge repeatedly (the checkpointed loop,
    benchmarks) should hoist this — the operator's stage/weight arrays
    are gigabytes at scale and must not be re-staged per call."""
    _check_shards(op.num_shards, mesh)
    return op.device_arrays(mesh, dtype, alpha=alpha)


def _resolve_routed(op, mesh: Mesh, dtype, alpha: float):
    """Accept a ShardedRoutedOperator or an (operator, placed_arrs) pair."""
    if isinstance(op, tuple):
        return op[0], op[1]
    return op, place_sharded_routed(op, mesh, dtype, alpha)


def _shard_scores(s0, dtype, mesh: Mesh) -> list:
    return shard(as_tensor(s0).reshape(-1).to(dtype), mesh)


def sharded_routed_converge_fixed(op, s0, num_iterations: int, mesh: Mesh,
                                  alpha: float = 0.0, dtype=torch.float32):
    """Fixed-iteration sharded routed power iteration. Returns the full
    state-order score vector on shard 0's device (use
    ``op.scores_for_nodes``). ``op``: a ShardedRoutedOperator, or
    (operator, placed_arrs) with placed_arrs from
    :func:`place_sharded_routed` to skip per-call staging."""
    meta, arrs = _resolve_routed(op, mesh, dtype, alpha)
    blocks = _shard_scores(s0, dtype, mesh)

    def run():
        b = blocks
        for _ in range(num_iterations):
            b = sharded_routed_spmv(arrs, b, meta, mesh)
        return unshard(b)

    return timed_converge("sharded-routed", meta.n, int(meta.nnz), run,
                          fixed_iterations=num_iterations)


def sharded_routed_converge_adaptive(op, s0, mesh: Mesh, tol: float = 1e-6,
                                     max_iterations: int = 100,
                                     alpha: float = 0.0,
                                     dtype=torch.float32):
    """Tolerance-based sharded routed power iteration.
    Returns (state_scores, iterations, final_relative_delta), the scores
    on shard 0's device. ``op`` as in
    :func:`sharded_routed_converge_fixed`."""
    meta, arrs = _resolve_routed(op, mesh, dtype, alpha)
    blocks = _shard_scores(s0, dtype, mesh)

    def run():
        b, iters, delta = mesh_adaptive_loop(
            lambda x: sharded_routed_spmv(arrs, x, meta, mesh), blocks, tol,
            max_iterations, mesh)
        return unshard(b), iters, delta

    return timed_converge("sharded-routed", meta.n, int(meta.nnz), run)
