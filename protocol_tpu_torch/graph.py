"""Trust-graph construction: from raw attestation edges to an operator.

The port's own copy of ``protocol_tpu/graph.py`` (pure numpy, kept
bit-identical to it so one edge list builds the same operator in both
packages).

This is the scale path the reference lacks (its opinion matrix is a dense
NUM_NEIGHBOURS×NUM_NEIGHBOURS array, ``circuits/dynamic_sets/native.rs``).
Semantics preserved exactly, reformulated for sparse million-peer graphs:

- **filtering** (native.rs:234-283): self-edges and edges touching invalid
  peers are dropped; a valid peer with no surviving out-edges becomes
  *dangling* and its score is redistributed uniformly to every other valid
  peer — the reference materializes that as a dense row of 1s; here it is
  the PageRank-style implicit rank-1 dangling-mass correction (SURVEY.md
  §7.3), mathematically identical and never materialized.
- **normalization** (native.rs:305-314): out-edge weights divided by the
  row sum (float here; the field/rational twins live in ``models``).

The device layout is a **degree-bucketed padded-ELL transpose**: rows
(= in-edge lists, since the iteration is s ← Cᵀs) are grouped into
power-of-two width buckets, each packed [rows, width]. SpMV is then pure
gather + row-reduce per bucket — no scatter, no dynamic shapes, fully
vectorizable on the VPU — followed by one permutation gather to restore row
order. Hub nodes (power-law graphs have ~√N max in-degree) cost at most 2×
padding instead of N×K dense ELL blowup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class EllOperator:
    """Bucketed-ELL normalized trust operator (host numpy; cheap to ship
    to device). All arrays are little pytree leaves; meta stays static.

    ``row_pos[i]`` indexes into the concatenation of all bucket outputs
    (+ one trailing zero slot) to recover row i's gathered sum.
    """

    n: int
    n_valid: int
    widths: tuple  # bucket widths, ascending
    bucket_idx: list  # per bucket: int32 [rows_b, width_b] source ids
    bucket_val: list  # per bucket: float64 [rows_b, width_b] weights
    row_pos: np.ndarray  # int32 [n]
    valid: np.ndarray  # float32 [n] 1.0 where slot holds a valid peer
    dangling: np.ndarray  # float32 [n] 1.0 where valid but no out-edges

    @property
    def nnz_padded(self) -> int:
        return sum(int(np.prod(b.shape)) for b in self.bucket_idx)


def stable_argsort_bounded(key: np.ndarray, bound: int) -> np.ndarray:
    """Stable argsort of non-negative ints < ``bound`` via LSD radix
    over 16-bit digits. numpy's ``kind='stable'`` on int64 is a
    mergesort; composing its RADIX path for uint16 digits is faster and
    bit-identical (tested). The operator builds' edge sorts are the
    fresh-build bottleneck at scale, so every one of them routes here."""
    k = np.asarray(key)
    if len(k) == 0 or bound <= 1:
        # all keys equal (or nothing to sort): stable order = identity
        return np.arange(len(k), dtype=np.int64)
    order = np.argsort((k & 0xFFFF).astype(np.uint16), kind="stable")
    shift = 16
    while int(bound) > (1 << shift):
        d = ((k[order] >> shift) & 0xFFFF).astype(np.uint16)
        order = order[np.argsort(d, kind="stable")]
        shift += 16
    return order


def filter_edges(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    val: np.ndarray,
    valid: np.ndarray | None = None,
    return_raw: bool = False,
):
    """Apply the reference's opinion-filter semantics to an edge list.

    Returns (src, dst, weight, valid_mask, dangling_mask) with weights
    row-normalized. Duplicate (src, dst) edges are summed (matching the
    reference where each truster has one score per peer — dedup keeps the
    build independent of the input order).

    ``return_raw=True`` appends ``(raw_val, row_sum)`` to the tuple: the
    deduped UN-normalized edge values (same order as the filtered edges —
    sorted by ``src * n + dst``) and the per-row sums they normalize by.
    The incremental delta engine (``protocol_tpu.incremental``) keys its
    edge index off this exact ordering, so the raw view lives here rather
    than being re-derived with subtly different sort semantics.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    val = np.asarray(val, dtype=np.float64)
    if valid is None:
        valid = np.ones(n, dtype=bool)
    else:
        valid = np.asarray(valid, dtype=bool)

    keep = (src != dst) & valid[src] & valid[dst] & (val > 0)
    src, dst, val = src[keep], dst[keep], val[keep]

    # merge duplicate edges
    if len(src):
        key = src * n + dst
        order = stable_argsort_bounded(key, n * n)
        key, src, dst, val = key[order], src[order], dst[order], val[order]
        # key is sorted: boundaries by diff (np.unique would RE-sort)
        first = np.nonzero(
            np.concatenate(([True], key[1:] != key[:-1])))[0]
        val = np.add.reduceat(val, first)
        src, dst = src[first], dst[first]

    row_sum = np.bincount(src, weights=val, minlength=n)
    dangling = valid & (row_sum == 0)
    weight = val / row_sum[src] if len(src) else val
    if return_raw:
        return src, dst, weight, valid, dangling, val, row_sum
    return src, dst, weight, valid, dangling


def transpose_buckets(n: int, src, dst, weight, min_width: int = 8):
    """Shared transpose + degree-bucketing pass for the ELL operator builds.

    Sorts edges by destination (transpose CSR order), computes each row's
    in-degree and intra-row offset, and assigns every row a ceil-pow2
    bucket width floored at ``min_width`` (0 = no bucket for in-degree-0
    rows). Both the single-device and sharded operator builds consume
    this so their bucketing rules can never diverge.

    Returns (dst_s, src_s, w_s, offset_in_row, widths_per_row, used_widths).
    """
    order = stable_argsort_bounded(dst, n)
    dst_s = dst[order].astype(np.int64)
    src_s = src[order].astype(np.int32)
    w_s = weight[order]  # keep float64 on host; cast at device transfer

    indeg = np.bincount(dst_s, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(indeg, out=indptr[1:])
    offset_in_row = np.arange(len(dst_s), dtype=np.int64) - indptr[dst_s]

    widths_per_row = np.maximum(
        min_width, 2 ** np.ceil(np.log2(np.maximum(indeg, 1))).astype(np.int64)
    )
    widths_per_row[indeg == 0] = 0  # no bucket
    used_widths = tuple(sorted(int(w) for w in np.unique(widths_per_row) if w > 0))
    return dst_s, src_s, w_s, offset_in_row, widths_per_row, used_widths


def build_operator(
    n: int,
    src: np.ndarray,
    dst: np.ndarray,
    val: np.ndarray,
    valid: np.ndarray | None = None,
    min_width: int = 8,
) -> EllOperator:
    """Filter + normalize an edge list and pack the transpose into
    degree-bucketed ELL."""
    src, dst, weight, valid_mask, dangling = filter_edges(n, src, dst, val, valid)
    dst_s, src_s, w_s, offset_in_row, widths_per_row, used_widths = transpose_buckets(
        n, src, dst, weight, min_width
    )

    bucket_idx, bucket_val = [], []
    row_pos = np.full(n, -1, dtype=np.int64)
    base = 0
    for w in used_widths:
        rows = np.nonzero(widths_per_row == w)[0]
        nb = len(rows)
        local = np.full(n, -1, dtype=np.int64)
        local[rows] = np.arange(nb)
        idx_mat = np.zeros((nb, w), dtype=np.int32)
        val_mat = np.zeros((nb, w), dtype=np.float64)
        mask = widths_per_row[dst_s] == w
        flat = local[dst_s[mask]] * w + offset_in_row[mask]
        idx_mat.reshape(-1)[flat] = src_s[mask]
        val_mat.reshape(-1)[flat] = w_s[mask]
        bucket_idx.append(idx_mat)
        bucket_val.append(val_mat)
        row_pos[rows] = base + np.arange(nb)
        base += nb
    # rows with no in-edges read the trailing zero slot
    row_pos[row_pos < 0] = base

    return EllOperator(
        n=n,
        n_valid=int(valid_mask.sum()),
        widths=used_widths,
        bucket_idx=bucket_idx,
        bucket_val=bucket_val,
        row_pos=row_pos.astype(np.int32),
        valid=valid_mask.astype(np.float32),
        dangling=dangling.astype(np.float32),
    )


def dense_normalized(matrix: Sequence[Sequence[float]]) -> np.ndarray:
    """Row-normalize a dense opinion matrix (zero rows stay zero) — the
    float twin of the field normalization in native converge."""
    m = np.asarray(matrix, dtype=np.float64)
    sums = m.sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    return m / sums


def barabasi_albert_edges(n: int, m: int, seed: int = 0, low: int = 1, high: int = 10):
    """Synthetic power-law trust graph for benchmarks (BASELINE.md configs).

    Vectorized preferential attachment via the repeated-nodes trick: each
    new node attaches to m targets sampled from the flattened edge-endpoint
    list (degree-proportional). Returns (src, dst, val) with both
    directions attested, values uniform in [low, high].
    """
    rng = np.random.default_rng(seed)
    # seed clique of m+1 nodes
    seed_nodes = np.arange(m + 1)
    src0 = np.repeat(seed_nodes, m)
    dst0 = np.concatenate([np.delete(seed_nodes, i) for i in range(m + 1)])

    # preferential attachment, chunked for vectorization: targets sampled
    # degree-proportionally from the preallocated endpoint pool of all
    # edges so far (the repeated-nodes trick); exact BA would update the
    # pool per node, which is O(n) python — chunking keeps the power-law
    # tail while staying vectorized.
    n_edges = len(src0) + (n - (m + 1)) * m
    src = np.empty(n_edges, dtype=np.int64)
    dst = np.empty(n_edges, dtype=np.int64)
    pool = np.empty(2 * n_edges, dtype=np.int64)
    src[: len(src0)] = src0
    dst[: len(dst0)] = dst0
    pool[: len(src0)] = src0
    pool[len(src0) : 2 * len(src0)] = dst0
    e_fill, p_fill = len(src0), 2 * len(src0)

    next_node = m + 1
    chunk = max(1024, n // 256)
    while next_node < n:
        count = min(chunk, n - next_node)
        new_nodes = np.arange(next_node, next_node + count)
        targets = pool[rng.integers(0, p_fill, size=(count, m))]
        # self-loops filtered later by filter_edges
        s = np.repeat(new_nodes, m)
        d = targets.reshape(-1)
        src[e_fill : e_fill + count * m] = s
        dst[e_fill : e_fill + count * m] = d
        pool[p_fill : p_fill + count * m] = s
        pool[p_fill + count * m : p_fill + 2 * count * m] = d
        e_fill += count * m
        p_fill += 2 * count * m
        next_node += count
    # mutual attestation: both directions
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    val = rng.integers(low, high + 1, size=len(src)).astype(np.float64)
    return src, dst, val
