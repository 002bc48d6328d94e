"""Poseidon Fiat–Shamir transcript over BN254 Fr.

The reference's proof transcripts are Poseidon sponges with WIDTH=5
(``eigentrust-zk/src/verifier/transcript/native.rs:23-157``: absorb
scalars and EC points, squeeze challenges). Same design here:

- scalars absorb directly;
- curve points absorb as coordinate limbs: each Fq coordinate splits
  into (lo 128 bits, hi bits) so the embedding into Fr is injective —
  q > r, so a single mod-r absorb would alias coordinates that differ
  by r (a Fiat–Shamir soundness hole the split avoids);
- each challenge squeeze absorbs a round counter first, so consecutive
  challenges are distinct even with no interleaved data.
"""

from __future__ import annotations

from ..crypto.poseidon import PoseidonSponge
from ..utils.fields import Fr

_MASK128 = (1 << 128) - 1

# Single source of truth for the Fiat-Shamir domain label: the native
# transcripts AND the generated Yul verifiers derive their initial state
# from this exact byte string.
TRANSCRIPT_LABEL = b"protocol-tpu-plonk"


class PoseidonTranscript:
    """Shared prover/verifier transcript; both sides replay the same
    absorb sequence, so challenges agree."""

    def __init__(self, label: bytes = TRANSCRIPT_LABEL):
        self.sponge = PoseidonSponge()
        self.rounds = 0
        seed = int.from_bytes(label, "little") % Fr.MODULUS
        self.sponge.update([Fr(seed)])

    def absorb_fr(self, value: int) -> None:
        self.sponge.update([Fr(int(value))])

    def absorb_point(self, pt) -> None:
        """G1 point (or None identity) as 4 limbs; a domain tag keeps the
        identity distinct from the scalar 0."""
        if pt is None:
            self.sponge.update([Fr(1), Fr(0), Fr(0), Fr(0), Fr(0)])
            return
        x, y = pt
        self.sponge.update([
            Fr(2),
            Fr(x & _MASK128), Fr(x >> 128),
            Fr(y & _MASK128), Fr(y >> 128),
        ])

    def challenge(self) -> int:
        self.rounds += 1
        self.sponge.update([Fr(self.rounds)])
        return int(self.sponge.squeeze())


class KeccakTranscript:
    """Keccak-256 Fiat–Shamir transcript — the on-chain-cheap variant.

    The reference's EVM proofs use snark-verifier's keccak
    ``EvmTranscript`` (``verifier/mod.rs:116-145``) because one keccak
    of the absorbed data costs ~hundreds of gas where a Poseidon
    permutation costs tens of thousands. Same trade here; the native
    and generated-Yul sides replay the identical byte layout:

        challenge = keccak256(state ‖ absorbed 32-byte words ‖ round)
        state    ← challenge

    Points absorb as x‖y big-endian words (identity = two zero words —
    unambiguous, since (0, 0) is not on the curve)."""

    def __init__(self, label: bytes = TRANSCRIPT_LABEL):
        from ..utils.keccak import keccak256

        self._keccak = keccak256
        self.state = keccak256(label)
        self.buf = bytearray()
        self.rounds = 0

    def absorb_fr(self, value: int) -> None:
        self.buf += (int(value) % Fr.MODULUS).to_bytes(32, "big")

    def absorb_point(self, pt) -> None:
        if pt is None:
            self.buf += b"\x00" * 64
            return
        x, y = pt
        self.buf += int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")

    def challenge(self) -> int:
        self.rounds += 1
        data = self.state + bytes(self.buf) + self.rounds.to_bytes(32, "big")
        self.state = self._keccak(data)
        self.buf.clear()
        return int.from_bytes(self.state, "big") % Fr.MODULUS


def make_transcript(kind: str = "poseidon"):
    """Transcript factory shared by prover and verifier paths."""
    if kind == "poseidon":
        return PoseidonTranscript()
    if kind == "keccak":
        return KeccakTranscript()
    raise ValueError(f"unknown transcript kind {kind!r}")
