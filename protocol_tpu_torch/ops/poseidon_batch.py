"""Batched Poseidon hashing on torch — the ingest-scale hashing layer.

The port of the reference's row engine (``protocol_tpu/ops/
poseidon_batch.py::PoseidonBatch``): N width-5 Hades permutations at once
on the limb engine (``ops.fieldops``), every field multiply a launch of
the Montgomery kernel, bit-exact against the host ``crypto.poseidon``
(same constants). The reference's ingest hashes with its limb-plane
engine instead (``PoseidonBatchPlanes``, on the prover's field engine);
the digests are identical either way, and the port has the row engine
only, with the same ``hash_submit``/``hash_finalize`` split.

State layout: (n, WIDTH, L) Montgomery-domain limb rows. Round
constants and the MDS matrix are converted to Montgomery form once, on
the host, and kept on the instance's device.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..crypto.poseidon import DEFAULT_WIDTH, poseidon_params
from ..device import resolve_device
from ..utils.fields import Fr
from .fieldops import (
    NUM_LIMBS,
    FieldCtx,
    _lazy_rowsum_mod,
    _ripple,
    add_mod,
    from_limbs,
    from_mont,
    mont_mul,
    to_device,
    to_mont,
)


def get_poseidon_batch(modulus: int = Fr.MODULUS, width: int = DEFAULT_WIDTH,
                       device=None) -> "PoseidonBatch":
    """The shared instance per (modulus, width, device); ``device=None``
    means the GPU (raises without one)."""
    return _cached(modulus, width, str(resolve_device(device)))


@lru_cache(maxsize=8)
def _cached(modulus: int, width: int, device: str) -> "PoseidonBatch":
    return PoseidonBatch(modulus, width, device)


class PoseidonBatch:
    """One Poseidon instance (modulus, width) with its constants on one
    device. Prefer :func:`get_poseidon_batch`."""

    def __init__(self, modulus: int = Fr.MODULUS, width: int = DEFAULT_WIDTH,
                 device=None):
        self.device = resolve_device(device)
        self.ctx = FieldCtx(modulus)
        self.width = width
        rc, mds, full_rounds, partial_rounds = poseidon_params(width, modulus)
        self.full_rounds = full_rounds
        self.partial_rounds = partial_rounds
        r = self.ctx.r

        def to_m(vals):  # plain ints -> Montgomery rows, on the host
            return to_device([v % modulus * r % modulus for v in vals],
                             self.device)

        total_rounds = full_rounds + partial_rounds
        self.rc_m = to_m(rc).reshape(total_rounds, width, NUM_LIMBS)
        self.mds_m = to_m([mds[i][j] for i in range(width)
                           for j in range(width)]).reshape(width, width,
                                                           NUM_LIMBS)

    # --- device core ------------------------------------------------------
    def _sbox(self, x: torch.Tensor) -> torch.Tensor:
        """x^5 rowwise: 3 Montgomery multiplies."""
        x2 = mont_mul(self.ctx, x, x)
        x4 = mont_mul(self.ctx, x2, x2)
        return mont_mul(self.ctx, x4, x)

    def _mds_apply(self, state: torch.Tensor) -> torch.Tensor:
        """out[b, i] = Σ_j mds[i, j] · state[b, j]."""
        n, w, L = state.shape
        a = self.mds_m.expand(n, w, w, L).reshape(-1, L)
        b = state[:, None, :, :].expand(n, w, w, L).reshape(-1, L)
        prod = mont_mul(self.ctx, a, b).reshape(n, w, w, L)
        acc = _ripple(prod.sum(dim=2, dtype=torch.int32).reshape(n * w, L))
        return _lazy_rowsum_mod(self.ctx, acc).reshape(n, w, L)

    def _round(self, state: torch.Tensor, r: int, partial: bool) -> torch.Tensor:
        n, w, L = state.shape
        state = add_mod(
            self.ctx,
            state.reshape(n * w, L),
            self.rc_m[r].repeat(n, 1),
        ).reshape(n, w, L)
        if partial:
            lane0 = self._sbox(state[:, 0, :])
            state = torch.cat([lane0[:, None, :], state[:, 1:, :]], dim=1)
        else:
            state = self._sbox(state.reshape(n * w, L)).reshape(n, w, L)
        return self._mds_apply(state)

    def permute_mont(self, state: torch.Tensor) -> torch.Tensor:
        """Full Hades permutation on (n, width, L) Montgomery state."""
        half = self.full_rounds // 2
        for r in range(half):
            state = self._round(state, r, partial=False)
        for r in range(half, half + self.partial_rounds):
            state = self._round(state, r, partial=True)
        for r in range(half + self.partial_rounds,
                       self.full_rounds + self.partial_rounds):
            state = self._round(state, r, partial=False)
        return state

    # --- host conveniences ------------------------------------------------
    def _to_state(self, states) -> torch.Tensor:
        flat = [int(v) for row in states for v in row]
        return to_mont(self.ctx, to_device(flat, self.device)).reshape(
            len(states), self.width, NUM_LIMBS)

    def permute(self, states) -> list:
        """(n, width) plain ints → (n, width) plain ints, one permutation
        each; bit-exact twin of ``crypto.poseidon.Poseidon.permute``."""
        n, w = len(states), self.width
        out = self.permute_mont(self._to_state(states))
        vals = from_limbs(
            from_mont(self.ctx, out.reshape(n * w, NUM_LIMBS)).cpu().numpy())
        return [vals[i * w:(i + 1) * w] for i in range(n)]

    def hash_submit(self, inputs) -> tuple:
        """Dispatch half of ``hash_batch``: the host limb build and the
        permutation's launches, without waiting for them. Returns a
        handle for ``hash_finalize``; the split lets a chunked ingest hash
        chunk i+1 while the card runs chunk i's recovery."""
        w = self.width
        padded = [list(row) + [0] * (w - len(row)) for row in inputs]
        out = self.permute_mont(self._to_state(padded))
        return (from_mont(self.ctx, out[:, 0, :].contiguous()), len(inputs))

    @staticmethod
    def hash_finalize(handle) -> list:
        """Download half of ``hash_batch``: waits for the permutation and
        converts the digests to host ints."""
        digests, n = handle
        return from_limbs(digests.cpu().numpy())[:n]

    def hash_batch(self, inputs) -> list:
        """Batch of ≤width-length input tuples → lane-0 digests; twin of
        ``Poseidon.hash`` (zero-padded single permutation). This is the
        ingest path: one call hashes every attestation in the batch."""
        return self.hash_finalize(self.hash_submit(inputs))
