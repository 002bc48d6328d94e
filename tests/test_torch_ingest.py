"""The port's batched ingest (Poseidon hashing, secp256k1 recovery and
verification) against the JAX package's host oracles.

All equalities are exact: hashes, recovered points and validity masks
are integer results, and the port must give the oracle's bit for bit.
The oracles are the reference's host ``Poseidon``, ``Attestation.hash``,
``recover_public_key`` and ``EcdsaVerifier`` (the ones
``tests/test_secp_batch.py`` holds the reference's own batched ladders
to). The reference's batched ``recover_batch``/``verify_batch`` are not
called: their compile takes minutes on a CPU.

The port runs on the CPU with the kernels' plain versions. One
module-scoped set of six lanes (valid, flipped parity, unliftable r,
r ≥ n, s = 0, a full-byte rec_id) goes through two recovery ladders in
all: one ``recover_signers_batch(full_verify=True)`` call, whose
``recover_batch`` and ``verify_batch`` results are recorded on the way,
and one ``recover_stream``.
"""

import random

import numpy as np
import pytest

from protocol_tpu.client.attestation import (
    SignedAttestationData as JSignedAttestationData,
)
from protocol_tpu.crypto.poseidon import Poseidon as JPoseidon
from protocol_tpu.crypto.secp256k1 import EcdsaVerifier as JEcdsaVerifier
from protocol_tpu.crypto.secp256k1 import PublicKey as JPublicKey
from protocol_tpu.crypto.secp256k1 import AffinePoint as JAffinePoint
from protocol_tpu.crypto.secp256k1 import Signature as JSignature
from protocol_tpu.crypto.secp256k1 import recover_public_key as j_recover
from protocol_tpu.utils.fields import Fr as JFr
from protocol_tpu_torch.client import ingest
from protocol_tpu_torch.client.attestation import (
    AttestationData,
    SignatureData,
    SignedAttestationData,
)
from protocol_tpu_torch.crypto.secp256k1 import N, P, EcdsaKeypair
from protocol_tpu_torch.ops import secp_batch as sb
from protocol_tpu_torch.ops.poseidon_batch import PoseidonBatch, get_poseidon_batch
from protocol_tpu_torch.utils.fields import Fr

KINDS = ("valid", "flipped_parity", "unliftable_r", "r_at_least_n",
         "s_zero", "rec_id_27")


def _unliftable_r(rng) -> int:
    while True:
        r = rng.randrange(1, N)
        rhs = (pow(r, 3, P) + 7) % P
        if pow(rhs, (P + 1) // 4, P) ** 2 % P != rhs:
            return r


@pytest.fixture(scope="module")
def lanes():
    """Six signed attestations, one of each kind, and the host oracle's
    verdict on each: (x, y) of the recovered key, or None where the
    scalar path raises."""
    rng = random.Random(20)
    kps = [EcdsaKeypair(rng.randrange(1, N)) for _ in range(3)]
    atts = []
    for i, kind in enumerate(KINDS):
        data = AttestationData(
            about=rng.randbytes(20), domain=rng.randbytes(20),
            value=rng.randrange(256), message=rng.randbytes(32))
        sig = kps[i % 3].sign(int(data.to_scalar().hash()))
        r, s, rec = sig.r, sig.s, sig.rec_id
        if kind == "flipped_parity":
            rec ^= 1
        elif kind == "unliftable_r":
            r = _unliftable_r(rng)
        elif kind == "r_at_least_n":
            r = N + 5
        elif kind == "s_zero":
            s = 0
        elif kind == "rec_id_27":
            rec = 27  # any nonzero rec_id selects the odd y
        atts.append(SignedAttestationData(
            data, SignatureData(r.to_bytes(32, "big"), s.to_bytes(32, "big"),
                                rec)))
    want = []
    for a in atts:
        ref = JSignedAttestationData.from_log(
            a.attestation.about, b"eigen_trust_" + a.attestation.domain,
            a.to_payload())
        assert ref.signature.to_bytes() == a.signature.to_bytes()
        try:
            pk = ref.recover_public_key()
            want.append((pk.point.x, pk.point.y))
        except (AssertionError, ValueError):
            want.append(None)
    assert want[0] is not None and want[2] is None and want[3] is None
    return atts, want


def _oracle_verify(sig: JSignature, msg: int, xy) -> bool:
    pk = JPublicKey(JAffinePoint(*xy)) if xy != (0, 0) else JPublicKey()
    return JEcdsaVerifier(sig, msg, pk).verify()


@pytest.fixture(scope="module")
def single(lanes):
    """recover_signers_batch(full_verify=True) on the six lanes, with
    the results of the recover_batch and verify_batch calls inside it."""
    atts, _ = lanes
    seen = {}
    real_recover, real_verify = sb.recover_batch, sb.verify_batch

    def recover_spy(*args, **kw):
        seen["recover_args"] = args
        seen["recover"] = real_recover(*args, **kw)
        return seen["recover"]

    def verify_spy(*args, **kw):
        seen["verify_args"] = args
        seen["verify"] = real_verify(*args, **kw)
        return seen["verify"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sb, "recover_batch", recover_spy)
        mp.setattr(sb, "verify_batch", verify_spy)
        seen["signers"] = ingest.recover_signers_batch(
            atts, full_verify=True, device="cpu")
    return seen


def test_recover_batch_matches_host_oracle(lanes, single):
    _, want = lanes
    rs, ss, recs, msgs = single["recover_args"]
    assert len(rs) == 8  # six lanes padded to the power-of-two bucket
    assert rs[6:] == [1, 1] and ss[6:] == [1, 1] and recs[6:] == [0, 0]
    xs, ys, valid = single["recover"]
    for i, w in enumerate(want):
        assert bool(valid[i]) == (w is not None), KINDS[i]
        if w is not None:
            assert (xs[i], ys[i]) == w, KINDS[i]
    # the same lanes, one by one, through the reference's host recover
    for i in range(6):
        try:
            pk = j_recover(JSignature(rs[i], ss[i], recs[i]), msgs[i])
            assert (xs[i], ys[i]) == (pk.point.x, pk.point.y)
        except (AssertionError, ValueError):
            assert not valid[i]


def test_verify_batch_matches_host_verifier(single):
    rs, ss, msgs, points = single["verify_args"]
    ok = single["verify"]
    assert ok.dtype == bool and ok.shape == (8,)
    for i in range(8):
        assert bool(ok[i]) == _oracle_verify(
            JSignature(rs[i], ss[i], 0), msgs[i], points[i]), i
    # recover ⇒ verify: audit mode never changes the mask
    assert np.array_equal(single["recover"][2] & ok, single["recover"][2])


def test_recover_signers_batch_matches_scalar_path(lanes, single):
    atts, want = lanes
    pub_keys, addresses, valid = single["signers"]
    assert valid.dtype == bool and valid.shape == (6,)
    for i, (a, w) in enumerate(zip(atts, want)):
        if w is None:
            assert not valid[i] and pub_keys[i] is None
            assert addresses[i] is None
            continue
        assert valid[i]
        assert (pub_keys[i].point.x, pub_keys[i].point.y) == w
        ref_pk = JPublicKey(JAffinePoint(*w))
        assert addresses[i] == ref_pk.to_address_bytes()
    # the flipped parity recovers someone else; the full-byte rec_id
    # recovers the signer iff the signer's R has odd y, as on the host
    assert valid[1] and addresses[1] != addresses[0]


def test_recover_stream_matches_host_oracle(lanes, single):
    _, want = lanes
    rs, ss, recs, msgs = single["recover_args"]
    out = list(sb.recover_stream([(rs, ss, recs, msgs)], device="cpu"))
    assert len(out) == 1
    xs, ys, valid = out[0]
    ref_xs, ref_ys, ref_valid = single["recover"]
    assert xs == ref_xs and ys == ref_ys
    assert np.array_equal(valid, ref_valid)
    for i, w in enumerate(want):
        assert bool(valid[i]) == (w is not None)


def test_attestation_hashes_match_reference(lanes, single):
    atts, _ = lanes
    msgs = single["recover_args"][3][:6]
    for a, m in zip(atts, msgs):
        ref = JSignedAttestationData.from_log(
            a.attestation.about, b"eigen_trust_" + a.attestation.domain,
            a.to_payload())
        assert m == int(ref.attestation.to_scalar().hash())
    assert single["recover_args"][3][6:] == [1, 1]  # pad lanes: msg = 1


def test_poseidon_permute_and_hash_match_host():
    pb = PoseidonBatch(device="cpu")
    rng = random.Random(4)
    p = Fr.MODULUS
    states = [[0] * 5, [p - 1] * 5,
              [rng.randrange(p) for _ in range(5)],
              [rng.randrange(p) for _ in range(5)]]
    want = [[int(v) for v in JPoseidon([JFr(x) for x in s], 5).permute()]
            for s in states]
    assert pb.permute(states) == want
    rows = [[rng.randrange(p) for _ in range(k)] for k in (1, 4, 5)]
    assert pb.hash_batch(rows) == [
        int(JPoseidon.hash([JFr(v) for v in r], 5)) for r in rows]
    # the submit/finalize split gives the same digests
    assert pb.hash_finalize(pb.hash_submit(rows)) == pb.hash_batch(rows)


def test_get_poseidon_batch_is_shared_per_device():
    a = get_poseidon_batch(device="cpu")
    assert a is get_poseidon_batch(device="cpu")
    assert a.device.type == "cpu" and a.rc_m.device.type == "cpu"


def test_empty_batch_and_padding_rules(monkeypatch):
    xs, ys, valid = ingest.recover_signers_batch([], device="cpu")
    assert xs == [] and ys == [] and valid.dtype == bool
    assert valid.shape == (0,)
    assert [ingest._pow2_bucket(k) for k in (1, 4, 5, 8, 9)] == [
        4, 4, 8, 8, 16]
    assert ingest._ingest_chunk() == 1 << 15
    monkeypatch.setenv("PTPU_INGEST_CHUNK", "4")
    assert ingest._ingest_chunk() == 4
