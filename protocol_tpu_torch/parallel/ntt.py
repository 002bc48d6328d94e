"""Sharded NTT over a device mesh: the proving stack's distributed seam,
the counterpart of ``protocol_tpu/parallel/ntt.py``.

The four-step NTT (``ops/ntt_tpu.py``) sees its ``(n, 22)`` canonical
Montgomery rows as an A × B grid (row-major, natural order in, FS layout
out), and the mesh shards it on the **B axis** (columns):

- stage 1 (W_A over the A axis) touches only the A axis → shard-local;
- the cross twiddle (one B2 ``mont_mul``) is pointwise → the twiddle
  table shards the same way;
- stage 2 contracts over the SHARDED axis (z[k1,k2] = Σ_j2 y[k1,j2]·
  W_B[k2,j2]): each shard builds the exact lazy plane accumulator of
  its own j2 slice (``ntt_tpu.stage_accum``, the single-device stage's
  accumulator fed that slice of W_B) and one ``psum_scatter`` hands
  every shard exactly its k2 tile of the integer total, which it folds
  mod p (``fieldops2.reduce_planes``) on its own.

The partial accumulators add up, as int32 planes, to the single-device
one (each plane stays below 2^31 for the whole sum), so the output is
``ntt_tpu.ntt``'s bit for bit. The inverse mirrors it: its first stage
contracts the sharded axis. ``ShardedRound3`` (``parallel/prover.py``)
runs its transforms on these blocks.
"""

from __future__ import annotations

import torch

from ..ops import fieldops2 as f2
from ..ops import ntt_tpu
from .mesh import Mesh, psum_scatter

L = f2.L


def column_blocks(x: torch.Tensor, A: int, B: int, mesh: Mesh) -> list:
    """(A·B, ·) rows of an A × B grid → one (A·B/D, ·) block of grid
    columns per shard, on its device (rows in (a, b_local) order)."""
    D = mesh.size
    if B % D:
        raise ValueError(f"B={B} must divide over {D} devices")
    Bd = B // D
    g = x.reshape(A, B, *x.shape[1:])
    return [g[:, d * Bd:(d + 1) * Bd].reshape(A * Bd, *x.shape[1:])
            .to(dev).contiguous() for d, dev in enumerate(mesh.devices)]


def gather_columns(blocks: list, A: int) -> torch.Tensor:
    """Inverse of :func:`column_blocks`, on shard 0's device."""
    device = blocks[0].device
    tail = blocks[0].shape[1:]
    g = torch.cat([b.to(device).reshape(A, -1, *tail) for b in blocks], 1)
    return g.reshape(-1, *tail)


class ShardedPlan:
    """An ``NttPlan``'s tables placed on a mesh: W_A and its inverse on
    every shard, each shard's contracted-axis slice of W_B and its
    inverse, and each shard's column block of the twiddles."""

    def __init__(self, plan: ntt_tpu.NttPlan, mesh: Mesh):
        self.plan, self.mesh = plan, mesh
        self.A, self.B = plan.A, plan.B
        D = mesh.size
        if self.B % D:
            raise ValueError(f"B={self.B} must divide over {D} devices")
        self.Bd = Bd = self.B // D
        devs = mesh.devices

        def in_slices(w):  # (44, out, in) → per shard (44, out, in/D)
            return [w[:, :, d * Bd:(d + 1) * Bd].to(dev).contiguous()
                    for d, dev in enumerate(devs)]

        self.w_a = [plan.W_A.to(dev) for dev in devs]
        self.w_a_inv = [plan.W_A_inv.to(dev) for dev in devs]
        self.w_b = in_slices(plan.W_B)
        self.w_b_inv = in_slices(plan.W_B_inv)
        self.t = column_blocks(plan.T, self.A, self.B, mesh)
        self.t_inv = column_blocks(plan.T_inv, self.A, self.B, mesh)


def ntt_blocks(xs: list, sp: ShardedPlan) -> list:
    """Forward NTT of column blocks (natural order) → FS-layout column
    blocks: rows (k1, k2_local) on every shard."""
    A, Bd = sp.A, sp.Bd
    partials = []
    for d, x in enumerate(xs):
        y = ntt_tpu.field_stage(x, A, Bd, 0, sp.w_a[d])   # rows (k1, j2)
        y = f2.mont_mul(y, sp.t[d])
        partials.append(ntt_tpu.stage_accum(y, A, Bd, 1, sp.w_b[d]))
    tiles = psum_scatter(partials, sp.mesh, scatter_dim=2)
    return [f2.reduce_planes(t) for t in tiles]


def intt_blocks(zs: list, sp: ShardedPlan) -> list:
    """Inverse NTT of FS-layout column blocks → natural-order column
    blocks (j1, j2_local), scaled by n⁻¹."""
    A, Bd = sp.A, sp.Bd
    partials = [ntt_tpu.stage_accum(z, A, Bd, 1, sp.w_b_inv[d])
                for d, z in enumerate(zs)]
    tiles = psum_scatter(partials, sp.mesh, scatter_dim=2)
    out = []
    for d, t in enumerate(tiles):
        y = f2.mont_mul(f2.reduce_planes(t), sp.t_inv[d])  # rows (k1, j2)
        x = ntt_tpu.field_stage(y, A, Bd, 0, sp.w_a_inv[d])  # (j1, j2)
        out.append(f2.mont_mul_const(x, sp.plan.n_inv_mont))
    return out


def ntt_sharded(x: torch.Tensor, plan: ntt_tpu.NttPlan, mesh: Mesh,
                axis: str | None = None) -> torch.Tensor:
    """Forward NTT of (n, 22) Montgomery rows over a 1-D mesh; output
    (on shard 0's device) equals ``ntt_tpu.ntt`` bit for bit (FS
    layout). Raises ``ValueError`` when B does not divide over the
    mesh. ``axis`` names the mesh axis (it has one)."""
    sp = ShardedPlan(plan, mesh)
    return gather_columns(
        ntt_blocks(column_blocks(x, plan.A, plan.B, mesh), sp), plan.A)
