"""Batched attestation ingest: signatures validated on the card at scale.

The port of ``protocol_tpu/client/ingest.py``. The scalar ingest path
(``SignedAttestationData.recover_public_key`` per attestation) performs
one Poseidon hash and one EC scalar multiply per attestation on the
host. This module replaces that loop with two batched device stages:

1. all attestation hashes in one batched Poseidon permutation
   (``ops.poseidon_batch``),
2. all pubkey recoveries in one batched GLV + fixed-base-window ladder
   (``ops.secp_batch``). Validity comes from recovery's own binding
   checks (r/s range, curve lift, non-∞) — recover⇒verify is an
   algebraic identity, so the scalar path's second verification ladder
   is redundant work (the reference keeps it only as a debug assert,
   ``ecdsa/native.rs:322-328``), and ``full_verify=True`` re-enables it
   for audits.

Batches pad to the next power of two, as the reference's do; above
``PTPU_INGEST_CHUNK`` attestations (default 2^15) they are chunked and
software-pipelined. Outputs are host objects (PublicKey, 20-byte
addresses) identical to the scalar path. Every entry point takes
``device=None``, which means the GPU, and raises without one.
``recover_signers_batch`` runs its stages under the reference's spans
(``ingest.pipeline``, ``ingest.hash_batch``, ``ingest.recover_batch``,
``ingest.verify_batch``).
"""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np

from ..crypto.secp256k1 import AffinePoint, PublicKey
from ..device import resolve_device
from ..models.eigentrust import HASHER_WIDTH
from ..utils import trace


# host seconds of the per-lane address derivation (a keccak each), summed
# over calls until reset; chip_smoke.py reads it for the ingest's host share
HOST_SECONDS = {"addresses": 0.0}


def reset_host_seconds() -> None:
    for k in HOST_SECONDS:
        HOST_SECONDS[k] = 0.0


def _pow2_bucket(k: int) -> int:
    """Batch size padded to a power of two (min 4), as the reference
    pads its batches."""
    size = 4
    while size < k:
        size *= 2
    return size


def _ingest_chunk() -> int:
    """Lanes of one ladder chunk; PTPU_INGEST_CHUNK overrides."""
    return int(os.environ.get("PTPU_INGEST_CHUNK", str(1 << 15)))


def hash_recover_pipeline(row_chunks, sig_chunks, device=None, _prep=None,
                          _glv=None):
    """Software-pipelined hash + recovery over pre-chunked inputs,
    yielding ``(msgs, (xs, ys, valid))`` per chunk in order.

    While the card runs chunk i's GLV ladder (the dominant span), the
    host hashes chunk i+1 and builds its limbs — the submit/midstage/
    finalize split in ``ops.secp_batch`` plus the hash_submit/finalize
    split in ``ops.poseidon_batch``. Per-chunk results are bit-identical
    to the serial hash_batch → recover_batch sequence (same kernels,
    same order within a chunk). ``sig_chunks`` entries are
    ``(rs, ss, rec_ids)`` lists; ``row_chunks`` entries are hasher input
    rows. ``_prep``/``_glv`` replace the recovery's device stages
    (``ops.secp_batch.recover_submit``/``recover_midstage``)."""
    from ..ops import secp_batch as sb
    from ..ops.poseidon_batch import get_poseidon_batch

    dev = resolve_device(device)
    row_chunks = list(row_chunks)
    sig_chunks = list(sig_chunks)
    assert len(row_chunks) == len(sig_chunks)
    if not row_chunks:
        return
    pb = get_poseidon_batch(width=HASHER_WIDTH, device=dev)
    mid = None
    pending_msgs = None
    hh = pb.hash_submit(row_chunks[0])
    for i in range(len(row_chunks)):
        msgs = pb.hash_finalize(hh)
        rs, ss, recs = sig_chunks[i]
        sub = sb.recover_submit(rs, ss, recs, msgs, device=dev, _prep=_prep)
        if i + 1 < len(row_chunks):
            hh = pb.hash_submit(row_chunks[i + 1])
        if mid is not None:
            yield pending_msgs, sb.recover_finalize(mid)
        pending_msgs = msgs
        mid = sb.recover_midstage(sub, _glv=_glv)
    yield pending_msgs, sb.recover_finalize(mid)


def _att_rows(attestations: Sequence) -> list:
    """Hasher input rows (``Attestation.hash`` operand order) for a
    batch of SignedAttestationData."""
    rows = []
    for signed in attestations:
        att = signed.attestation.to_scalar()
        rows.append([int(att.about), int(att.domain), int(att.value),
                     int(att.message)])
    return rows


def attestation_hashes_batch(attestations: Sequence, device=None) -> list:
    """Poseidon attestation hashes for a batch of SignedAttestationData
    (``Attestation.hash``: Poseidon_5(about, domain, value, message, 0)),
    padded to the same power-of-two bucket as the recovery ladder."""
    from ..ops.poseidon_batch import get_poseidon_batch

    pb = get_poseidon_batch(width=HASHER_WIDTH, device=device)
    rows = _att_rows(attestations)
    k = len(rows)
    rows += [[0, 0, 0, 0]] * (_pow2_bucket(k) - k)
    return pb.hash_batch(rows)[:k]


def recover_signers_batch(attestations: Sequence,
                          full_verify: bool = False, device=None):
    """Batched twin of per-attestation ``recover_public_key``.

    Returns (pub_keys, addresses, valid): recovered ``PublicKey``s,
    their 20-byte addresses, and a bool mask. Lanes failing any stage
    come back invalid instead of raising — batch ingest must not let
    one malformed attestation poison the rest.

    Validity is the binding-check set ``recover_batch`` enforces
    (r, s ∈ [1, n), r lifts onto the curve, result ≠ ∞) — by
    construction the recovered key then satisfies the verify equation
    (R' = z·s⁻¹·G + r·s⁻¹·Q = s⁻¹·(z·G + (s·R − z·G)) = R), so the
    second full verification ladder the scalar path runs is a
    re-derivation, not an independent check. ``full_verify=True``
    re-enables it for audits — it must never change the mask.
    """
    from ..ops.secp_batch import recover_batch, verify_batch

    dev = resolve_device(device)
    if not attestations:
        return [], [], np.zeros(0, dtype=bool)

    k = len(attestations)
    cap = _ingest_chunk()
    if k > cap:
        # beyond one chunk: chunk AND software-pipeline
        # (hash_recover_pipeline) — host prep of chunk i+1 hides under
        # the device ladder of chunk i
        rows = _att_rows(attestations)
        sigs = [s.signature.to_signature() for s in attestations]
        row_chunks, sig_chunks, spans = [], [], []
        for lo in range(0, k, cap):
            hi = min(lo + cap, k)
            pad_c = _pow2_bucket(hi - lo) - (hi - lo)
            row_chunks.append(rows[lo:hi] + [[0, 0, 0, 0]] * pad_c)
            sig_chunks.append((
                [s.r for s in sigs[lo:hi]] + [1] * pad_c,
                [s.s for s in sigs[lo:hi]] + [1] * pad_c,
                [s.rec_id for s in sigs[lo:hi]] + [0] * pad_c))
            spans.append(hi - lo)
        xs, ys, valid_parts = [], [], []
        with trace.span("ingest.pipeline", n=k, chunks=len(spans)):
            for (msgs_c, (cx, cy, cvalid)), c, (crs, css, _) in zip(
                    hash_recover_pipeline(row_chunks, sig_chunks,
                                          device=dev),
                    spans, sig_chunks):
                if full_verify:
                    # audit mode: the synchronous verify ladder between
                    # chunks serializes the pipeline
                    with trace.span("ingest.verify_batch", n=c):
                        ok = verify_batch(crs, css, msgs_c,
                                          list(zip(cx, cy)), device=dev)
                    cvalid = cvalid & ok
                xs.extend(cx[:c])
                ys.extend(cy[:c])
                valid_parts.append(cvalid[:c])
        valid = np.concatenate(valid_parts)
    else:
        pad = _pow2_bucket(k) - k
        with trace.span("ingest.hash_batch", n=k):
            msgs = [int(h) for h in attestation_hashes_batch(attestations,
                                                             device=dev)]
        sigs = [s.signature.to_signature() for s in attestations]
        rs = [s.r for s in sigs] + [1] * pad
        ss = [s.s for s in sigs] + [1] * pad
        rec = [s.rec_id for s in sigs] + [0] * pad
        msgs_p = msgs + [1] * pad
        with trace.span("ingest.recover_batch", n=k):
            xs, ys, valid = recover_batch(rs, ss, rec, msgs_p, device=dev)
        if full_verify:
            with trace.span("ingest.verify_batch", n=k):
                ok = verify_batch(rs, ss, msgs_p, list(zip(xs, ys)),
                                  device=dev)
            valid = valid & ok
        xs, ys, valid = xs[:k], ys[:k], valid[:k]

    t0 = time.perf_counter()
    pub_keys = []
    addresses = []
    for x, y, v in zip(xs, ys, valid):
        if v:
            pk = PublicKey(AffinePoint(int(x), int(y)))
            pub_keys.append(pk)
            addresses.append(pk.to_address_bytes())
        else:
            pub_keys.append(None)
            addresses.append(None)
    HOST_SECONDS["addresses"] += time.perf_counter() - t0
    return pub_keys, addresses, np.asarray(valid)
