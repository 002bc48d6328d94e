"""Sharded PLONK round 3 — the prover's distributed seam, the
counterpart of ``protocol_tpu/parallel/prover.py``:

    ext (coset-scale + NTT)  →  quotient  →  inverse NTT + combine

- every (n, 22) array of the ``DeviceProver`` is an A × B grid of
  canonical Montgomery rows, sharded on the **B axis** over a 1-D mesh
  (``parallel/ntt.py``'s column blocks); the FS layout's flat index
  k1·B + k2 is the (A, B) ravel, so a shard holds the same columns of
  every table, natural or FS;
- the forward and inverse NTTs pay ONE ``psum_scatter`` each over the
  mesh (``ntt_blocks``/``intt_blocks``); everything else in the
  pipeline is pointwise and needs no exchange;
- the quotient identity is the single-device one
  (``prover_tpu.quotient_pointwise``, one home for the math), run per
  shard; the only exchange it needs is z(ωX)/φ(ωX): an FS-layout roll
  whose wrap row crosses the shard boundary, served by a one-element
  ``ppermute`` from the next shard;
- the radix-4 cross-chunk combine of the 4n inverse is pointwise per
  chunk (``prover_tpu._fold``).

Every product is B2 (``mont_mul``), every sum ``add_mod``/``sub_mod``,
on each shard's device; every output equals the ``DeviceProver``'s own
bit for bit. A sharded array is a list of per-shard (A·B/D, 22) blocks.
"""

from __future__ import annotations

import torch

from ..ops import fieldops2 as f2
from ..utils import trace
from ..zk import prover_tpu as ptpu
from .mesh import Mesh, ppermute
from .ntt import (
    ShardedPlan,
    column_blocks,
    gather_columns,
    intt_blocks,
    ntt_blocks,
)

L = f2.L
EXT_COSETS = ptpu.EXT_COSETS


class ShardedRound3:
    """Round-3 pipeline over a 1-D mesh, table-compatible with a
    ``DeviceProver``: its tables are the prover's own, re-placed as
    column blocks on the mesh."""

    def __init__(self, dp: ptpu.DeviceProver, mesh: Mesh,
                 axis: str | None = None):
        self.dp = dp
        self.mesh = mesh
        self.axis = axis or mesh.axis_names[0]
        self.A, self.B = dp.A, dp.B
        self.D = mesh.size
        if self.B % self.D:
            raise ValueError(
                f"B={self.B} must divide over {self.D} devices")

        def rows(t):  # a small table, on every shard
            return [t.to(dev) for dev in mesh.devices]

        # mesh placement of the DeviceProver's static tables — the
        # sharded pipeline's init cost, attributed like a prover stage
        with trace.span("parallel.r3_place_tables", k=dp.k,
                        shards=self.D):
            self.sp = ShardedPlan(dp.plan, mesh)
            self.coset_pows = [self.shard(t) for t in dp.coset_pows]
            self.xs_fs = [self.shard(t) for t in dp.xs_fs]
            self.l0_fs = [self.shard(t) for t in dp.l0_fs]
            self.we_neg_pows = [self.shard(t) for t in dp.we_neg_pows]
            self.s_neg_pows = self.shard(dp.s_neg_pows)
            self.zh_rows = [rows(t) for t in dp.zh_rows]
            self.zh_inv_rows = [rows(t) for t in dp.zh_inv_rows]
            self.zc_rows = [rows(t) for t in dp.zc_rows]
            self.su_rows = rows(dp.su_rows)
            trace.device_sync(self.s_neg_pows)
        self._tc: dict = {}

    def shard(self, x: torch.Tensor) -> list:
        """Place an (n, 22) device array on the mesh as column blocks."""
        return column_blocks(x, self.A, self.B, self.mesh)

    def gather(self, blocks: list) -> torch.Tensor:
        """Column blocks → the (n, 22) array on shard 0's device."""
        return gather_columns(blocks, self.A)

    # --- sharded building blocks -----------------------------------------

    def _roll_next(self, blocks: list) -> list:
        """FS-layout z(ωX) roll of column blocks: rows shift locally; the
        wrap row's global lane roll fetches ONE element from the next
        shard."""
        D = self.D
        grids = [b.view(self.A, -1, L) for b in blocks]
        recv = ppermute([g[:1, :1] for g in grids], self.mesh,
                        [((d + 1) % D, d) for d in range(D)])
        return [torch.cat([g[1:], torch.cat([g[:1, 1:], r], dim=1)])
                .reshape(-1, L) for g, r in zip(grids, recv)]

    def ext_chunk(self, coeffs: list, j: int, blinds=None) -> list:
        """Sharded twin of ``DeviceProver.ext_chunk``: column blocks of
        coefficients → the FS-layout ext chunk's column blocks."""
        scaled = [f2.mont_mul(c, cp)
                  for c, cp in zip(coeffs, self.coset_pows[j])]
        chunk = ntt_blocks(scaled, self.sp)
        if not blinds:
            return chunk
        return [ptpu._blind(c, xs, zh, f2.mont_rows(blinds, c.device))
                for c, xs, zh in zip(chunk, self.xs_fs[j], self.zh_rows[j])]

    def quotient_chunk(self, j: int, wires_e, z_e, m_e, phi_e, pi_e,
                       uv_e, ch: torch.Tensor) -> list:
        """Sharded z-split quotient: the single-device pointwise core on
        every shard, with the two FS rolls served by one-element
        ppermutes. Inputs are column blocks; ``ch`` the (17, 22)
        challenge rows."""
        dp = self.dp
        if not dp.ext_resident:
            raise ValueError(
                "quotient_chunk needs a resident-mode DeviceProver: in "
                "streaming mode fixed_ext/sigma_ext are not "
                "materialized, so there are no pk tables to reshard. "
                "Construct the DeviceProver with ext_resident=True "
                "(each shard holds n/D lanes, so the resident tables "
                "that exceed one card fit the mesh); the ext/intt "
                "stages work in either mode.")
        fixed = [self._reshard_table(("fixed", i, j), dp.fixed_ext[i][j])
                 for i in range(9)]
        sigma = [self._reshard_table(("sigma", i, j), dp.sigma_ext[i][j])
                 for i in range(6)]
        zw = self._roll_next(z_e)
        phiw = self._roll_next(phi_e)
        with trace.span("parallel.r3_quotient_chunk", j=j, shards=self.D):
            out = []
            for d, dev in enumerate(self.mesh.devices):
                out.append(ptpu.quotient_pointwise(
                    [w[d] for w in wires_e], z_e[d], zw[d], m_e[d],
                    phi_e[d], phiw[d], pi_e[d], [u[d] for u in uv_e],
                    [f[d] for f in fixed], [s[d] for s in sigma],
                    self.xs_fs[j][d], self.l0_fs[j][d], ch.to(dev),
                    self.zh_inv_rows[j][d]))
            trace.device_sync(out)
        return out

    def _reshard_table(self, key, table: torch.Tensor) -> list:
        # keyed by (table_kind, column, chunk); each entry pins a strong
        # reference to its source tensor and re-validates with `is`, so a
        # rebuilt pk table can neither alias a recycled id() nor hit a
        # stale positional entry — it just re-places
        hit = self._tc.get(key)
        if hit is not None and hit[0] is table:
            return hit[1]
        out = self.shard(table)
        self._tc[key] = (table, out)
        return out

    def intt_chunk(self, z: list) -> list:
        """Sharded inverse NTT of one FS-layout chunk (mirror of the
        forward: its first stage contracts the sharded axis)."""
        return intt_blocks(z, self.sp)

    def intt_ext(self, t_chunks: list) -> list:
        """Sharded twin of ``DeviceProver.intt_ext``: per-chunk sharded
        iNTTs + the pointwise radix-4 cross-chunk combine. Returns
        EXT_COSETS coefficient chunks, each as column blocks."""
        with trace.span("parallel.r3_intt_ext", shards=self.D):
            hats = []
            for j in range(EXT_COSETS):
                cj = self.intt_chunk(t_chunks[j])
                hats.append([f2.mont_mul(c, w)
                             for c, w in zip(cj, self.we_neg_pows[j])])
            out = []
            for u in range(EXT_COSETS):
                blocks = []
                for d in range(self.D):
                    acc = ptpu._fold(self.zc_rows[u][d],
                                     [h[d] for h in hats])
                    acc = f2.mont_mul(acc, self.s_neg_pows[d])
                    blocks.append(f2.mont_mul(acc, ptpu._bcast(
                        self.su_rows[d][u:u + 1], acc.shape[0])))
                out.append(blocks)
            trace.device_sync(out)
        return out
