"""Clos-network routing of static permutations: the port's planner and
executor (counterpart of ``protocol_tpu/ops/clos.py``).

Any static permutation of ``E = 2^e`` slots factors into a radix-128
Clos network: lane permutations within ``[rows, 128]`` tiles
(``out[r, j] = x[r, idx[r, j]]``) with transposes between them, over
``2·levels − 1`` stages. The plan (per-stage ``uint8`` lane indices) is
computed once per graph on the host, by the port's copy of the C++
planner (``protocol_tpu_torch.native``) or by the pure-Python twin
below; the planner code here is a copy of the reference's and produces
the same bytes.

The executor runs on torch tensors. Each stage, its transpose included,
is one launch of the hand-written CUDA kernel ``ops.kernels.route_stage``
on the card (whatever its row count), and its plain version on the CPU:
``torch.gather`` with the reference's reshapes and transposes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kernels import FORWARD, MIDDLE, REVERSE, route_stage

__all__ = [
    "RoutePlan",
    "plan_route",
    "plan_route_py",
    "plan_routes",
    "apply_route",
    "apply_route_np",
    "route_bits",
    "route_core",
    "route_forms",
]


def route_bits(e: int) -> tuple:
    """Radix schedule for a 2^e-slot network: 7-bit (128-lane) levels with
    the remainder on the innermost (base) level."""
    if e <= 7:
        return (e,)
    nlev = -(-e // 7)
    rem = e - 7 * (nlev - 1)
    return (7,) * (nlev - 1) + (rem,)


@dataclass
class RoutePlan:
    """Routing program for ``y[d] = x[perm[d]]`` over ``E = 2^e`` slots.

    ``stages`` are flat uint8 arrays of length E in execution order
    (level-0 input, level-1 input, …, base, …, level-1 output, level-0
    output); ``stages[s][d]`` is the absolute lane (0..127) within slot
    d's 128-lane row that stage ``s`` reads from.
    """

    e: int
    bits: tuple
    stages: list

    @property
    def num_slots(self) -> int:
        return 1 << self.e


# --------------------------------------------------------------------------
# Planner (pure Python reference; the C++ twin lives in protocol_native)
# --------------------------------------------------------------------------


def _color_regular_bipartite(src_row, dst_row, m, r):
    """r-edge-color an r-regular bipartite multigraph given per-edge
    endpoints (both sides have ``m`` vertices). Recursive Euler halving:
    split a d-regular multigraph into two d/2-regular halves by
    2-coloring edges alternately along closed walks (every closed walk
    in a bipartite graph has even length, so the alternation pairs each
    vertex's incident edges), then recurse. Returns int32 color/edge."""
    E = len(src_row)
    colors = np.empty(E, dtype=np.int32)

    def split(eids, d, c0):
        if d == 1:
            colors[eids] = c0
            return
        k = len(eids)
        ls = src_row[eids]
        rs = dst_row[eids]
        lptr = np.zeros(m + 1, dtype=np.int64)
        rptr = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(np.bincount(ls, minlength=m), out=lptr[1:])
        np.cumsum(np.bincount(rs, minlength=m), out=rptr[1:])
        ladj = np.argsort(ls, kind="stable")
        radj = np.argsort(rs, kind="stable")
        lcur = lptr[:-1].copy()
        rcur = rptr[:-1].copy()
        used = np.zeros(k, dtype=bool)
        side_a = np.zeros(k, dtype=bool)

        for start in range(k):
            if used[start]:
                continue
            v = int(ls[start])
            on_left = True
            parity = True
            while True:
                if on_left:
                    cur, ptr, adj = lcur, lptr, ladj
                else:
                    cur, ptr, adj = rcur, rptr, radj
                eid = -1
                while cur[v] < ptr[v + 1]:
                    cand = adj[cur[v]]
                    cur[v] += 1
                    if not used[cand]:
                        eid = int(cand)
                        break
                if eid < 0:
                    break  # closed walk complete (back at its start)
                used[eid] = True
                side_a[eid] = parity
                parity = not parity
                v = int(rs[eid]) if on_left else int(ls[eid])
                on_left = not on_left

        split(eids[side_a], d // 2, c0)
        split(eids[~side_a], d // 2, c0 + d // 2)

    split(np.arange(E, dtype=np.int64), r, 0)
    return colors


def plan_route_py(perm: np.ndarray) -> RoutePlan:
    """Pure-Python planner (small sizes, tests). ``perm`` must be a
    bijection on [0, 2^e), e ≥ 7; semantics y[d] = x[perm[d]]."""
    perm = np.asarray(perm, dtype=np.int64)
    E = len(perm)
    e = E.bit_length() - 1
    if (1 << e) != E or e < 7:
        raise ValueError("plan_route: length must be a power of two ≥ 128")
    bits = route_bits(e)
    nstages = 2 * len(bits) - 1
    stages = [np.zeros(E, dtype=np.uint8) for _ in range(nstages)]

    def rec(perm_l, slot_off, level):
        El = len(perm_l)
        if level == len(bits) - 1:
            # base: within-2^b-block permutation, absolute lane indices
            r = 1 << bits[level]
            sl = np.arange(El, dtype=np.int64) + slot_off
            block_base = (sl & 127) & ~(r - 1)
            stages[level][sl] = (block_base + perm_l).astype(np.uint8)
            return
        ml = El >> 7
        i_src = perm_l >> 7
        d_loc = np.arange(El, dtype=np.int64)
        i_dst = d_loc >> 7
        color = _color_regular_bipartite(i_src, i_dst, ml, 128)

        stages[level][slot_off + i_src * 128 + color] = (
            perm_l & 127
        ).astype(np.uint8)
        stages[nstages - 1 - level][slot_off + d_loc] = color.astype(np.uint8)

        mid = np.empty(El, dtype=np.int64)
        mid[color * ml + i_dst] = i_src
        for k in range(128):
            rec(mid[k * ml : (k + 1) * ml], slot_off + k * ml, level + 1)

    rec(perm.copy(), 0, 0)
    return RoutePlan(e=e, bits=bits, stages=stages)


def plan_route(perm: np.ndarray, prefer_native: bool = True,
               validate: bool = True) -> RoutePlan:
    """Plan a static permutation route; uses the C++ planner when built
    (required in practice at large sizes), Python otherwise.

    ``validate`` replays the finished plan on the host
    (``apply_route_np`` over ``arange(E)``, far cheaper than the
    planning) and requires it to reproduce ``perm`` exactly: a
    consistent-but-wrong coloring would otherwise yield a non-bijective
    plan that silently corrupts every score it routes. On mismatch the
    native plan is discarded and the Python planner is tried once; if
    that also fails, raises.
    """
    import warnings

    perm = np.asarray(perm)
    E = len(perm)
    e = E.bit_length() - 1
    if (1 << e) != E or e < 7:
        raise ValueError("plan_route: length must be a power of two ≥ 128")

    native_plan_rejected = False

    def _check(plan, source):
        if not validate:
            return True
        probe = np.arange(E, dtype=np.int32 if e < 31 else np.int64)
        replay = None
        if e < 31:
            from .. import native as pn

            if pn.available():  # fused C++ replay
                replay = pn.clos_apply_route(plan.stages, plan.bits,
                                             probe)
        if replay is None:
            replay = apply_route_np(plan, probe)
        if np.array_equal(replay, perm):
            return True
        warnings.warn(
            f"plan_route: {source} planner produced a plan that does not "
            f"reproduce the permutation — discarding it",
            RuntimeWarning,
            stacklevel=3,
        )
        return False

    if prefer_native:
        from .. import native as pn

        if pn.available():
            bits = route_bits(e)
            stages_flat = pn.clos_plan(perm.astype(np.int32), bits)
            if stages_flat is not None:
                nstages = 2 * len(bits) - 1
                plan = RoutePlan(
                    e=e,
                    bits=bits,
                    stages=[stages_flat[s * E : (s + 1) * E]
                            for s in range(nstages)],
                )
                if _check(plan, "native"):
                    return plan
                native_plan_rejected = True
    if e > 20:
        reason = ("native planner produced an invalid plan (bug — please "
                  "report)" if native_plan_rejected
                  else "native planner unavailable")
        warnings.warn(
            f"plan_route: {reason}; falling back to the pure-Python "
            f"Euler-split planner, which visits every one of the 2^{e} "
            f"slots in Python — expect this to take a very long time",
            RuntimeWarning,
            stacklevel=2,
        )
    plan = plan_route_py(perm)
    if not _check(plan, "python"):
        raise RuntimeError(
            "plan_route: no planner produced a valid plan for this "
            "permutation"
        )
    return plan


def plan_routes(perms, prefer_native: bool = True) -> list:
    """Plan several independent permutations, overlapping their builds
    on host threads. The routed operator needs two plans per graph (the
    edge route and the smaller state route); the native planner
    releases the GIL for its whole walk, so the state plan rides in the
    edge plan's shadow. Each native plan also fans its 128 level-0
    sub-splits across the CPU count (``CLOS_PLAN_THREADS`` overrides)."""
    perms = list(perms)
    if len(perms) <= 1:
        return [plan_route(p, prefer_native=prefer_native) for p in perms]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(perms)) as pool:
        futs = [pool.submit(plan_route, p, prefer_native)
                for p in perms]
        return [f.result() for f in futs]


# --------------------------------------------------------------------------
# Executor
# --------------------------------------------------------------------------


def apply_route_np(plan: RoutePlan, x: np.ndarray) -> np.ndarray:
    """Numpy twin of the device executor (planner validation)."""
    E = plan.num_slots
    bits = plan.bits
    x = np.asarray(x).reshape(E)
    si = 0
    for li in range(len(bits) - 1):
        B, m = 1 << (7 * li), E >> (7 * (li + 1))
        idx = plan.stages[si].reshape(-1, 128)
        x = np.take_along_axis(x.reshape(-1, 128), idx, axis=1)
        x = x.reshape(B, m, 128).swapaxes(1, 2).reshape(E)
        si += 1
    idx = plan.stages[si].reshape(-1, 128)
    x = np.take_along_axis(x.reshape(-1, 128), idx, axis=1).reshape(E)
    si += 1
    for li in reversed(range(len(bits) - 1)):
        B, m = 1 << (7 * li), E >> (7 * (li + 1))
        x = x.reshape(B, 128, m).swapaxes(1, 2).reshape(E)
        idx = plan.stages[si].reshape(-1, 128)
        x = np.take_along_axis(x.reshape(-1, 128), idx, axis=1).reshape(E)
        si += 1
    return x


def route_forms(e_sub: int, bits: tuple, si: int = 0) -> list:
    """``(stage index, form, m)`` of each stage of a route over B·2^e_sub
    slots, in execution order from stage ``si``: a forward stage per
    interior level, the middle one, then a reverse stage per interior
    level, each interior level's subproblems of m rows of 128."""
    levels = len(bits)
    ms = [1 << (e_sub - 7 * (li + 1)) for li in range(levels - 1)]
    return ([(si + li, FORWARD, m) for li, m in enumerate(ms)]
            + [(si + levels - 1, MIDDLE, 1)]
            + [(si + 2 * levels - 2 - li, REVERSE, ms[li])
               for li in reversed(range(levels - 1))])


def route_core(x: torch.Tensor, stages, si: int, e_sub: int, bits: tuple,
               stage=route_stage) -> torch.Tensor:
    """Apply a route program to ``x`` of length B·2^e_sub (B independent
    subproblems batched contiguously: every stage works on El-sized
    chunks, so subproblem boundaries are never crossed), or to a topic
    batch ``[K, B·2^e_sub]`` of such vectors, all routed by the same
    stages. ``stage`` runs one stage (``route_stage``, or its plain
    version)."""
    shape = x.shape
    rows = shape[:-1] + (-1, 128)
    for s, form, m in route_forms(e_sub, bits, si):
        x = stage(x.view(rows), stages[s].view(-1, 128), form,
                  m).view(shape)
    return x


def apply_route(x: torch.Tensor, stages, e: int, bits: tuple) -> torch.Tensor:
    """Route a tensor through a plan: returns y with ``y[d] = x[perm[d]]``.
    ``stages`` are flat uint8 tensors on x's device (``RoutePlan.stages``
    moved there)."""
    return route_core(x.reshape(-1), stages, 0, e, tuple(bits))
