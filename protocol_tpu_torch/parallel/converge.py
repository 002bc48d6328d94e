"""Row-sharded EigenTrust convergence over a device mesh: the
counterpart of ``protocol_tpu/parallel/converge.py``.

Each shard owns a contiguous block of graph rows (peers) and the
bucketed-ELL in-edge lists for those rows. Per iteration:

1. ``all_gather`` the score blocks over the mesh → the full score vector
   on every shard,
2. the gather SpMV over the shard's own buckets
   (``ops.converge.spmv_base``, the single-device sweep's core),
3. ``psum`` the dangling mass and the valid mass (scalars) and apply the
   rank-1 correction and the damping,
4. (adaptive mode) ``psum`` the local L1 delta for one global stopping
   predicate, read back to the host once per sweep.

The communication per iteration is one all-gather of the score vector
plus O(1) scalars. All shards share identical array shapes (bucket row
counts padded to the max across shards), as in the reference. The
operator build is host numpy, copied from the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..graph import filter_edges, transpose_buckets
from ..ops.converge import spmv_base
from .mesh import Mesh, all_gather, psum, shard, unshard


@dataclass
class ShardedOperator:
    """Per-shard bucketed-ELL operator (leading axis = shard)."""

    n: int  # true row count (before padding)
    n_pad: int  # padded to num_shards * n_local
    n_local: int
    num_shards: int
    n_valid: int
    widths: tuple
    bucket_idx: list  # per width: int32 [D, rows_w, w]
    bucket_val: list  # per width: float64 [D, rows_w, w]
    row_pos: np.ndarray  # int32 [D, n_local] into local flat (+zero slot)
    valid: np.ndarray  # float32 [D, n_local]
    dangling: np.ndarray  # float32 [D, n_local]

    def device_arrays(self, mesh: Mesh, dtype=torch.float32,
                      alpha: float = 0.0, pretrust=None) -> list:
        """One dict of tensors per shard, on that shard's device; see
        ``ops.converge.operator_arrays`` for the damping (alpha/pretrust)
        semantics. ``pretrust`` is in padded row order."""
        if pretrust is None:
            pretrust = self.valid.astype(np.float64) / max(self.n_valid, 1)
        pretrust = np.asarray(pretrust).reshape(self.num_shards, -1)

        def on(a, dev, dt=dtype):
            return torch.as_tensor(np.asarray(a), device=dev).to(dt)

        return [{
            "bucket_idx": tuple(on(b[d], dev, torch.int64)
                                for b in self.bucket_idx),
            "bucket_val": tuple(on(b[d], dev) for b in self.bucket_val),
            "row_pos": on(self.row_pos[d], dev, torch.int64),
            "valid": on(self.valid[d], dev),
            "dangling": on(self.dangling[d], dev),
            "alpha": torch.tensor(float(alpha), dtype=dtype, device=dev),
            "pretrust": on(pretrust[d], dev),
        } for d, dev in enumerate(mesh.devices)]

    def initial_scores(self, initial_score: float,
                       dtype=torch.float32) -> torch.Tensor:
        """The padded cold-start vector (CPU), ``initial_score`` on every
        valid row."""
        s0 = self.valid.reshape(-1).astype(np.float64) * float(initial_score)
        return torch.from_numpy(s0).to(dtype)


def build_sharded_operator(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    val: np.ndarray,
    valid: np.ndarray | None = None,
    num_shards: int = 1,
    min_width: int = 8,
) -> ShardedOperator:
    """Filter + normalize an edge list and pack per-shard bucketed ELL.

    Same trust semantics as ``graph.build_operator`` (one global filter
    pass), then rows are partitioned into ``num_shards`` contiguous blocks.
    Bucket widths are assigned globally (a row's bucket depends only on its
    in-degree) and per-width row counts are padded to the max across shards
    so every shard sees identical shapes.
    """
    src, dst, weight, valid_mask, dangling = filter_edges(n, src, dst, val, valid)

    n_local = -(-n // num_shards)  # ceil
    n_pad = n_local * num_shards

    dst_s, src_s, w_s, offset_in_row, widths_per_row, used_widths = transpose_buckets(
        n, src, dst, weight, min_width
    )

    shard_of_row = np.minimum(np.arange(n) // n_local, num_shards - 1)

    # per (shard, width) row counts, padded to max across shards
    counts = np.zeros((num_shards, len(used_widths)), dtype=np.int64)
    for wi, w in enumerate(used_widths):
        rows_w = widths_per_row == w
        counts[:, wi] = np.bincount(shard_of_row[rows_w], minlength=num_shards)
    max_counts = counts.max(axis=0)

    bucket_idx = [
        np.zeros((num_shards, int(mc), w), dtype=np.int32)
        for mc, w in zip(max_counts, used_widths)
    ]
    bucket_val = [
        np.zeros((num_shards, int(mc), w), dtype=np.float64)
        for mc, w in zip(max_counts, used_widths)
    ]
    zero_slot = int(max_counts.sum())
    row_pos = np.full((num_shards, n_local), zero_slot, dtype=np.int64)

    bases = np.concatenate([[0], np.cumsum(max_counts)[:-1]])
    # local row index within (shard, width) bucket
    local_in_bucket = np.full(n, -1, dtype=np.int64)
    for d in range(num_shards):
        lo, hi = d * n_local, min((d + 1) * n_local, n)
        rows_d = np.arange(lo, hi)
        for wi, w in enumerate(used_widths):
            rows = rows_d[widths_per_row[rows_d] == w]
            local_in_bucket[rows] = np.arange(len(rows))
            row_pos[d, rows - lo] = bases[wi] + np.arange(len(rows))

    for wi, w in enumerate(used_widths):
        mask = widths_per_row[dst_s] == w
        d_e = shard_of_row[dst_s[mask]]
        flat = local_in_bucket[dst_s[mask]] * w + offset_in_row[mask]
        bucket_idx[wi].reshape(num_shards, -1)[d_e, flat] = src_s[mask]
        bucket_val[wi].reshape(num_shards, -1)[d_e, flat] = w_s[mask]

    valid_pad = np.zeros(n_pad, dtype=np.float32)
    valid_pad[:n] = valid_mask.astype(np.float32)
    dangling_pad = np.zeros(n_pad, dtype=np.float32)
    dangling_pad[:n] = dangling.astype(np.float32)

    return ShardedOperator(
        n=n,
        n_pad=n_pad,
        n_local=n_local,
        num_shards=num_shards,
        n_valid=int(valid_mask.sum()),
        widths=used_widths,
        bucket_idx=bucket_idx,
        bucket_val=bucket_val,
        row_pos=row_pos.astype(np.int32),
        valid=valid_pad.reshape(num_shards, n_local),
        dangling=dangling_pad.reshape(num_shards, n_local),
    )


def psum_dangling_and_damping(arrs: list, s_blocks: list, bases: list,
                              n_valid: float, mesh: Mesh) -> list:
    """Mesh twin of ``ops.converge.dangling_and_damping``: the dangling
    rank-1 correction and damped pre-trust mixing with the cross-shard
    mass totals carried by psum. Shared by the gather and routed sharded
    sweeps so the semantics cannot desynchronize."""
    d_mass = psum([torch.sum(s * a["dangling"])
                   for a, s in zip(arrs, s_blocks)], mesh)
    total = psum([torch.sum(s * a["valid"])
                  for a, s in zip(arrs, s_blocks)], mesh)
    denom = max(n_valid - 1.0, 1.0)
    out = []
    for a, s, base, dm, tot in zip(arrs, s_blocks, bases, d_mass, total):
        corr = (dm - a["dangling"] * s) / denom
        propagated = base + corr * a["valid"]
        alpha = a["alpha"]
        out.append((1.0 - alpha) * propagated
                   + alpha * a["pretrust"] * tot)
    return out


def mesh_adaptive_loop(step, s_blocks: list, tol: float,
                       max_iterations: int, mesh: Mesh):
    """Mesh twin of ``ops.converge.adaptive_loop``: the relative-L1
    stopping predicate with the norm and the delta psum'd across shards,
    compared with ``tol`` rounded to the iterate's dtype. Returns
    ``(blocks, iterations, delta)``, the last two as Python numbers."""
    dtype = s_blocks[0].dtype
    norm = torch.clamp(psum([torch.sum(torch.abs(s)) for s in s_blocks],
                            mesh)[0], min=1.0)
    tol = float(torch.tensor(tol, dtype=dtype))
    i, delta = 0, math.inf
    while delta > tol and i < max_iterations:
        nxt = step(s_blocks)
        diff = psum([torch.sum(torch.abs(a - b))
                     for a, b in zip(nxt, s_blocks)], mesh)[0]
        delta = float(diff / norm)
        s_blocks, i = nxt, i + 1
    return s_blocks, i, delta


def _sweep(arrs: list, s_blocks: list, n_valid: float, mesh: Mesh) -> list:
    """One sharded sweep: all_gather the scores, gather-reduce each
    shard's buckets, psum the masses."""
    fulls = all_gather(s_blocks, mesh)
    bases = [spmv_base(a, f) for a, f in zip(arrs, fulls)]
    return psum_dangling_and_damping(arrs, s_blocks, bases, n_valid, mesh)


def _check_shards(num_shards: int, mesh: Mesh) -> None:
    if num_shards != mesh.size:
        raise ValueError(
            f"operator was built for {num_shards} shards but the mesh has "
            f"{mesh.size} devices; rebuild with num_shards={mesh.size}")


def place_sharded(sop: ShardedOperator, mesh: Mesh, dtype=torch.float32,
                  alpha: float = 0.0) -> list:
    """Build the per-shard tensors ONCE and place them on the mesh.

    Callers that converge repeatedly (benchmarks, the checkpointed
    loop) should hoist this, as ``ops.converge.operator_arrays`` is
    hoisted, so each call doesn't redo the O(nnz) host conversion and
    transfer."""
    _check_shards(sop.num_shards, mesh)
    return sop.device_arrays(mesh, dtype, alpha=alpha)


def _resolve_sharded(sop, mesh: Mesh, dtype, alpha: float):
    """Accept a ShardedOperator or a (ShardedOperator, placed_arrs) pair."""
    if isinstance(sop, tuple):
        _check_shards(sop[0].num_shards, mesh)
        return sop[0], sop[1]
    return sop, place_sharded(sop, mesh, dtype, alpha)


def as_tensor(s0) -> torch.Tensor:
    """A score vector given as a tensor or an array, as a tensor."""
    return s0 if isinstance(s0, torch.Tensor) else torch.as_tensor(
        np.asarray(s0))


def sharded_converge_fixed(sop, s0, num_iterations: int, mesh: Mesh,
                           alpha: float = 0.0) -> torch.Tensor:
    """Fixed-iteration sharded power iteration; returns the full (padded)
    score vector on shard 0's device — slice ``[:sop.n]`` for true rows.

    ``sop``: a ShardedOperator, or (ShardedOperator, placed_arrs) with
    ``placed_arrs`` from :func:`place_sharded` to skip per-call staging.
    """
    s0 = as_tensor(s0)
    meta, arrs = _resolve_sharded(sop, mesh, s0.dtype, alpha)
    blocks = shard(s0.reshape(-1), mesh)
    n_valid = float(meta.n_valid)
    for _ in range(num_iterations):
        blocks = _sweep(arrs, blocks, n_valid, mesh)
    return unshard(blocks)


def sharded_converge_adaptive(sop, s0, mesh: Mesh, tol: float = 1e-6,
                              max_iterations: int = 100,
                              alpha: float = 0.0):
    """Tolerance-based sharded power iteration.

    Returns (scores_padded, iterations, final_relative_delta), the
    scores on shard 0's device. ``sop`` as in
    :func:`sharded_converge_fixed`.
    """
    s0 = as_tensor(s0)
    meta, arrs = _resolve_sharded(sop, mesh, s0.dtype, alpha)
    n_valid = float(meta.n_valid)
    blocks, iters, delta = mesh_adaptive_loop(
        lambda b: _sweep(arrs, b, n_valid, mesh),
        shard(s0.reshape(-1), mesh), tol, max_iterations, mesh)
    return unshard(blocks), iters, delta
