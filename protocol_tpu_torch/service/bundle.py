"""Signed score bundles: verification-friendly cacheable reads.

The paper's core property makes the read path uniquely scalable:
published scores are *provable* (the EigenTrust KZG proof), so replicas,
CDNs and edge caches can serve score reads without being trusted — a
client verifies instead of trusting the server. The bundle is the unit
of that trust transfer: a canonical, byte-stable encoding of

    (leader address, graph revision, WAL position, score-vector digest,
     score count, computed_at, latest EigenTrust proof id)

signed with the SAME secp256k1/Poseidon machinery attestations use
(``EcdsaKeypair.sign`` over a Poseidon hash of the payload's Fr
embedding — RFC 6979 deterministic signing, so re-building an unchanged
bundle is byte-identical and strong ETags work). Verification needs no
chain access: recover the public key from the signature, derive the
eth address, compare against the leader address you already trust (the
same address whose attestations you accept) — then fetch
``/proofs/<et_proof_id>/proof.bin`` if you want the full KZG proof of
the scores themselves.

The canonical payload (all integers little-endian, matching the WAL
framing's struct discipline)::

    magic "PTPUBNDL1" | leader(20) | u64 revision | u64 wal_segment |
    u64 wal_offset | u32 n_scores | f64 computed_at |
    score_digest(32) | u16 len(proof_id) | proof_id utf-8

``score_digest`` is sha256 over the served table's address list and
float64 score bytes (``ScoreTable.digest`` — the same digest the
table's ETag derives from), so a bundle commits to the exact bytes
``GET /scores`` serves.
"""

from __future__ import annotations

import hashlib
import struct

from ..crypto.poseidon import Poseidon
from ..crypto.secp256k1 import Signature, recover_public_key
from ..models.eigentrust import HASHER_WIDTH
from ..utils.errors import EigenError
from ..utils.fields import Fr

BUNDLE_MAGIC = b"PTPUBNDL1"
_FIXED = struct.Struct("<QQQId")  # revision, wal seg, wal off, n, t

# domain separation: a bundle hash can never collide with an
# attestation hash (attestations hash 4 data lanes + a zero pad lane;
# the bundle puts its domain tag in lane 0)
_DOMAIN_TAG = Fr.from_uniform_bytes_le(b"ptpu-score-bundle-v1"
                                       + b"\x00" * 44)


def encode_bundle_payload(leader: bytes, revision: int, wal_pos: tuple,
                          score_digest: bytes, n_scores: int,
                          computed_at: float, proof_id: str) -> bytes:
    """The canonical signed bytes (see module docstring)."""
    if len(leader) != 20:
        raise EigenError("validation_error", "leader must be 20 bytes")
    if len(score_digest) != 32:
        raise EigenError("validation_error",
                         "score digest must be 32 bytes")
    pid = proof_id.encode()
    if len(pid) > 0xFFFF:
        raise EigenError("validation_error", "proof id too long")
    return (BUNDLE_MAGIC + leader
            + _FIXED.pack(int(revision) & (1 << 64) - 1,
                          int(wal_pos[0]), int(wal_pos[1]),
                          int(n_scores), float(computed_at))
            + score_digest + struct.pack("<H", len(pid)) + pid)


def decode_bundle_payload(payload: bytes) -> dict:
    """Inverse of :func:`encode_bundle_payload`; raises on malformed
    bytes (a verifier must parse what it checked, not trust JSON
    fields riding next to the signature)."""
    base = len(BUNDLE_MAGIC)
    if payload[:base] != BUNDLE_MAGIC:
        raise EigenError("parsing_error", "bad bundle magic")
    leader = payload[base:base + 20]
    fixed_end = base + 20 + _FIXED.size
    if len(payload) < fixed_end + 32 + 2:
        raise EigenError("parsing_error", "truncated bundle payload")
    revision, seg, off, n, t = _FIXED.unpack_from(payload, base + 20)
    digest = payload[fixed_end:fixed_end + 32]
    (plen,) = struct.unpack_from("<H", payload, fixed_end + 32)
    pid = payload[fixed_end + 34:fixed_end + 34 + plen]
    if len(payload) != fixed_end + 34 + plen:
        raise EigenError("parsing_error", "bundle payload length "
                                          "mismatch")
    return {
        "leader": leader,
        "revision": revision,
        "wal_position": (seg, off),
        "n_scores": n,
        "computed_at": t,
        "score_digest": digest,
        "et_proof_id": pid.decode(errors="replace"),
    }


def bundle_msg_hash(payload: bytes) -> int:
    """The signed scalar: Poseidon_5(domain_tag, H(payload) as Fr, 0,
    0, 0) lane 0 — the exact hasher shape attestations sign
    (``models.eigentrust.Attestation.hash``), with the sha256 payload
    digest embedded through the same wide reduction the attestation
    message uses."""
    digest = hashlib.sha256(payload).digest()
    body = Fr.from_uniform_bytes_le(digest + b"\x00" * 32)
    inputs = [_DOMAIN_TAG, body, Fr.zero(), Fr.zero(), Fr.zero()]
    return int(Poseidon(inputs, HASHER_WIDTH).finalize()[0])


def sign_bundle(keypair, payload: bytes) -> bytes:
    """65-byte r ‖ s ‖ rec_id over the bundle hash (RFC 6979 — the
    same payload always signs to the same bytes, which is what makes
    the bundle's strong ETag honest)."""
    sig = keypair.sign(bundle_msg_hash(payload))
    return (sig.r.to_bytes(32, "big") + sig.s.to_bytes(32, "big")
            + bytes([sig.rec_id]))


def verify_bundle(payload: bytes, signature: bytes,
                  leader: bytes | None = None) -> dict:
    """Recover the signer from ``signature`` over ``payload`` and check
    it IS the leader address embedded in the payload (and ``leader``
    when the caller pins one). Returns the decoded fields; raises
    ``EigenError`` on any mismatch — tampering with a single payload
    byte, the signature, or serving someone else's bundle under this
    leader's address all fail here."""
    from ..client.eth import address_from_public_key

    fields = decode_bundle_payload(payload)
    if len(signature) != 65:
        raise EigenError("validation_error",
                         "bundle signature must be 65 bytes")
    sig = Signature(int.from_bytes(signature[:32], "big"),
                    int.from_bytes(signature[32:64], "big"),
                    signature[64])
    try:
        pub = recover_public_key(sig, bundle_msg_hash(payload))
        signer = address_from_public_key(pub)
    except (EigenError, ValueError) as e:
        raise EigenError("validation_error",
                         f"bundle signature unrecoverable: {e}") from e
    if signer != fields["leader"]:
        raise EigenError("validation_error",
                         "bundle signer does not match the leader "
                         "address in the payload")
    if leader is not None and signer != leader:
        raise EigenError("validation_error",
                         "bundle signed by an unexpected leader")
    return fields


def bundle_json(payload: bytes, signature: bytes) -> dict:
    """The ``GET /bundle`` body: every field both decoded (for humans
    and dashboards) and as the exact signed payload hex (for
    verifiers — verification MUST parse the payload, not trust the
    decoded copies)."""
    fields = decode_bundle_payload(payload)
    seg, off = fields["wal_position"]
    return {
        "version": 1,
        "leader": "0x" + fields["leader"].hex(),
        "revision": fields["revision"],
        "wal_position": f"{seg}:{off}",
        "n_scores": fields["n_scores"],
        "computed_at": fields["computed_at"],
        "score_digest": fields["score_digest"].hex(),
        "et_proof_id": fields["et_proof_id"],
        "payload": payload.hex(),
        "signature": signature.hex(),
    }
