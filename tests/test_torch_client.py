"""The port's client SDK against the reference's, on the CPU.

The same mnemonics, chains and attestations go through
``protocol_tpu.client`` and ``protocol_tpu_torch.client``: the codecs
give the same bytes, the chains the same logs, and ``et_circuit_setup``
the same ``ETSetup`` (address set, opinion matrix, Fr scores, rational
scores, opinions hash). The batched ingest runs on ``device="cpu"``
with the plain versions of the field kernels. Twins of
``tests/test_client.py``.
"""

import importlib

import numpy as np
import pytest
import torch

from protocol_tpu import client as ref
from protocol_tpu_torch import client as port

TEST_MNEMONIC = "test test test test test test test test test test test junk"
M2 = "legal winner thank year wave sausage worth useful legal winner thank yellow"
M3 = "letter advice cage absurd amount doctor acoustic avoid letter advice cage above"
M4 = ("abandon abandon abandon abandon abandon abandon abandon abandon "
      "abandon abandon abandon about")
ANVIL_ADDR0 = "f39fd6e51aad88f6f4ce6ab8827279cfffb92266"
DOMAIN = bytes(range(20))


def make_client(pkg, mnemonic=TEST_MNEMONIC, chain=None, **kw):
    config = pkg.ClientConfig(domain="0x" + DOMAIN.hex())
    if pkg is port:
        kw.setdefault("device", "cpu")
    return pkg.Client(config, mnemonic, chain=chain, **kw)


def setup_fields(setup) -> dict:
    """Everything an ETSetup carries, as plain comparable values."""
    def scalars(xs):
        return [None if x is None else int(x) for x in xs]

    matrix, valid = setup.opinion
    return {
        "address_set": setup.address_set,
        "participants": scalars(setup.pub_inputs.participants),
        "scores_fr": scalars(setup.pub_inputs.scores),
        "domain": int(setup.pub_inputs.domain),
        "opinion_hash": int(setup.pub_inputs.opinion_hash),
        "rational": list(setup.rational_scores),
        "opinion": [[float(v) for v in row] for row in matrix],
        "valid": list(valid),
        "pub_keys": [None if pk is None else (pk.point.x, pk.point.y)
                     for pk in setup.pub_keys],
        "matrix": [[None if a is None else (
            int(a.attestation.about), int(a.attestation.value),
            int(a.attestation.message), a.signature.r, a.signature.s)
            for a in row] for row in setup.attestation_matrix],
        "pub_bytes": setup.pub_inputs.to_bytes(),
    }


def log_fields(chain) -> list:
    return [(log.creator, log.about, log.key, log.val, log.block_number)
            for log in chain.get_logs()]


# --- codecs ----------------------------------------------------------------

def _codec(pkg, case):
    """One codec case's output in one package (bytes, ints, or the
    EigenError kinds it raised)."""
    c = pkg
    chain = importlib.import_module(pkg.__name__ + ".chain")
    eth = importlib.import_module(pkg.__name__ + ".eth")
    sig = c.SignatureData(b"\x01" * 32, b"\x02" * 32, 1)
    if case == "rlp":
        items = [b"dog", [], b"", 0, 1024, [b"cat", b"dog"], b"\x7f",
                 b"\x80", b"x" * 60, [b"y" * 30, [1, 2, [3]], 2 ** 70]]
        return [eth.rlp_encode(x) for x in items]
    if case == "abi":
        entries = [(b"\xaa" * 20, b"\xbb" * 32, b"\xcc" * 66),
                   (b"\x01" * 20, b"\x02" * 32, b"\x03" * 98)]
        data = chain.abi_encode_attest(entries)
        enc = (32).to_bytes(32, "big") + (5).to_bytes(32, "big") \
            + b"hello" + b"\x00" * 27
        return [data, chain.ATTEST_SELECTOR, chain.ATTESTATIONS_SELECTOR,
                chain.EVENT_TOPIC, chain.abi_decode_bytes(enc)]
    if case in ("payload66", "payload98"):
        msg = b"\x33" * 32 if case == "payload98" else b"\x00" * 32
        att = c.AttestationData(about=b"\x11" * 20, domain=DOMAIN, value=9,
                                message=msg)
        signed = c.SignedAttestationData(att, sig)
        payload = signed.to_payload()
        back = c.SignedAttestationData.from_log(att.about, att.get_key(),
                                                payload)
        assert back == signed
        try:
            c.SignedAttestationData.from_log(att.about, att.get_key(),
                                             payload + b"\x00")
            bad = None
        except Exception as e:  # noqa: BLE001 - the kind is compared
            bad = (type(e).__name__, str(e))
        return [payload, len(payload), bad]
    if case == "raw_and_key":
        att = c.AttestationData(about=b"\x11" * 20, domain=DOMAIN, value=7,
                                message=b"\x22" * 32)
        raw = att.to_bytes()
        assert c.AttestationData.from_bytes(raw) == att
        s = att.to_scalar()
        return [raw, att.get_key(), int(s.about), int(s.domain),
                int(s.value), int(s.message), int(s.hash())]
    if case == "mnemonic":
        kps = eth.ecdsa_keypairs_from_mnemonic(TEST_MNEMONIC, 3)
        seed = eth.mnemonic_to_seed(M4, passphrase="TREZOR")
        addrs = [kp.public_key.to_address_bytes() for kp in kps]
        return [addrs, seed, int(eth.scalar_from_address(addrs[0]))]
    if case == "legacy_tx":
        kp = eth.ecdsa_keypairs_from_mnemonic(M2, 1)[0]
        return [eth.sign_legacy_tx(kp, 5, 10 ** 9, 100_000, b"\x22" * 20, 0,
                                   b"calldata", 31337)]
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["rlp", "abi", "payload66", "payload98",
                                  "raw_and_key", "mnemonic", "legacy_tx"])
def test_codec_vectors_match_reference(case):
    got, want = _codec(port, case), _codec(ref, case)
    assert got == want
    if case == "rlp":  # the reference's known vectors (test_client.py)
        assert [g.hex() for g in got[:6]] == [
            "83646f67", "c0", "80", "80", "820400", "c88363617483646f67"]
    elif case == "mnemonic":
        assert got[0][0].hex() == ANVIL_ADDR0
        assert got[1].hex().startswith("c55257c360c07c72029aebc1b53c05ed")
        assert got[2] == int(ANVIL_ADDR0, 16)
    elif case.startswith("payload"):
        assert got[1] == int(case[-2:])
        assert got[2][0] == "EigenError"


# --- the client flow --------------------------------------------------------

def _flow(pkg):
    """The reference test's flow: three clients rate each other on one
    local chain; returns the chain and the first client's setup."""
    chain = pkg.LocalChain()
    clients = [make_client(pkg, m, chain) for m in (TEST_MNEMONIC, M2, M3)]
    addrs = [cl.signer.public_key.to_address_bytes() for cl in clients]
    ratings = {0: [0, 8, 2], 1: [5, 0, 5], 2: [3, 7, 0]}
    for i, cl in enumerate(clients):
        for j, score in enumerate(ratings[i]):
            if i != j:
                cl.attest(addrs[j], score)
    atts = clients[0].get_attestations()
    return chain, clients[0], atts, clients[0].et_circuit_setup(atts), addrs


@pytest.fixture(scope="module")
def flows():
    return _flow(ref), _flow(port)


def test_attest_and_score_flow_on_local_chain(flows):
    (r_chain, r_cl, r_atts, r_setup, r_addrs), \
        (p_chain, p_cl, p_atts, p_setup, p_addrs) = flows
    assert p_addrs == r_addrs
    assert log_fields(p_chain) == log_fields(r_chain)
    assert p_chain.to_json() == r_chain.to_json()
    assert len(p_atts) == 6 and p_atts == [
        port.SignedAttestationData.from_log(
            a.attestation.about, a.attestation.get_key(), a.to_payload())
        for a in p_atts]
    assert [a.to_payload() for a in p_atts] == [a.to_payload() for a in r_atts]
    assert setup_fields(p_setup) == setup_fields(r_setup)

    scores = p_cl.scores_from_setup(p_setup)
    want = r_cl.scores_from_setup(r_setup)
    assert [(s.address, s.score_fr, s.numerator, s.denominator)
            for s in scores] == [(s.address, s.score_fr, s.numerator,
                                  s.denominator) for s in want]
    assert sum(s.ratio for s in scores) == 3 * 1000
    from protocol_tpu_torch.utils.fields import Fr

    for s in scores:
        expected = Fr(s.numerator) * Fr(s.denominator).invert()
        assert int(expected) == int.from_bytes(s.score_fr, "big")


@pytest.mark.parametrize("kind", ["dense", "sparse", "edges"])
def test_float_backends_match_reference(flows, kind):
    """The port's float32 torch backends against the reference's float32
    JAX backends on the same opinion matrix: within 1e-5 relative, and
    within the CLI's 1e-3 of the exact scores."""
    import jax.numpy as jnp

    from protocol_tpu import backend as rb
    from protocol_tpu_torch import backend as pb

    (_, r_cl, _, r_setup, _), (_, p_cl, _, p_setup, _) = flows
    matrix, _ = p_setup.opinion
    exact = np.array([float(x) for x in p_setup.rational_scores])
    if kind == "edges":  # the client's scale path, default backend
        m = np.asarray(matrix, dtype=np.float64)
        src, dst = np.nonzero(m)
        args = (len(m), src, dst, m[src, dst])
        got, it_p, _ = p_cl.calculate_scores_sparse(*args, tol=1e-9)
        want, it_r, _ = r_cl.calculate_scores_sparse(*args, tol=1e-9)
        assert abs(it_p - it_r) <= 1
    else:
        cls_p, cls_r = {"dense": (pb.TorchDenseBackend, rb.JaxDenseBackend),
                        "sparse": (pb.TorchSparseBackend,
                                   rb.JaxSparseBackend)}[kind]
        got = cls_p(dtype=torch.float32, device="cpu").converge(
            matrix, 1000, 20)
        want = cls_r(dtype=jnp.float32).converge(
            r_setup.opinion[0], 1000, 20)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, exact, rtol=1e-3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)


def test_unfiltered_matrix_rejected_like_reference():
    """A zero-row peer that still receives trust: both sparse backends
    refuse the dense route with the same error."""
    from protocol_tpu import backend as rb
    from protocol_tpu_torch import backend as pb

    matrix = [[0.0, 1.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    errors = []
    for b in (pb.TorchSparseBackend(device="cpu"), rb.JaxSparseBackend()):
        with pytest.raises(ValueError) as e:
            b.converge(matrix, 1000, 20)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "zero-row peers [1]" in errors[0]


def _twin_chains(attest):
    """The port's local chain after ``attest(chain)``, and the
    reference's loaded from its JSON form (so each flow signs once)."""
    chain = port.LocalChain()
    attest(chain)
    return (ref, ref.LocalChain.from_json(chain.to_json())), (port, chain)


@pytest.fixture(scope="module")
def two_peers():
    """Two peers attest each other, and a third peer attests the first
    under another domain on the same station."""
    def attest(chain):
        c1, c2 = make_client(port, TEST_MNEMONIC, chain), \
            make_client(port, M2, chain)
        a1 = c1.signer.public_key.to_address_bytes()
        c1.attest(c2.signer.public_key.to_address_bytes(), 10)
        c2.attest(a1, 10)
        port.Client(port.ClientConfig(domain="0x" + "ff" * 20), M3,
                    chain=chain, device="cpu").attest(a1, 9)

    return _twin_chains(attest)


def test_foreign_domain_attestations_filtered(two_peers):
    out = []
    for pkg, chain in two_peers:
        c1 = make_client(pkg, TEST_MNEMONIC, chain)
        atts = c1.get_attestations()
        assert len(atts) == 2 and len(chain.get_logs()) == 3
        # a foreign-domain attestation handed in directly is dropped too
        kw = {"device": "cpu"} if pkg is port else {}
        foreign = pkg.Client(pkg.ClientConfig(domain="0x" + "ff" * 20), M3,
                             chain=chain, **kw).get_attestations()
        assert len(foreign) == 1
        setup = c1.et_circuit_setup(atts + foreign)
        out.append((setup_fields(setup),
                    [(s.address, s.numerator, s.denominator)
                     for s in c1.scores_from_setup(setup)]))
    assert out[0] == out[1] and len(out[0][1]) == 2


def test_threshold_verification_flow(two_peers):
    out = []
    for pkg, chain in two_peers:
        c1 = make_client(pkg, TEST_MNEMONIC, chain)
        a1 = c1.signer.public_key.to_address_bytes()
        atts = c1.get_attestations()
        th = c1.th_circuit_setup(atts, a1, 900)
        assert th.pub_inputs.threshold_check  # both converge to 1000
        assert not c1.th_circuit_setup(atts, a1, 1100) \
            .pub_inputs.threshold_check
        with pytest.raises(Exception) as e:
            c1.verify_threshold(atts, b"\x99" * 20, 900)
        assert type(e.value).__name__ == "EigenError"
        out.append((th.pub_inputs.to_bytes(),
                    [int(x) for x in th.num_decomposed],
                    [int(x) for x in th.den_decomposed], th.ratio,
                    str(e.value)))
    assert out[0] == out[1]


def test_too_many_participants_rejected():
    def attest(chain):
        clients = [make_client(port, m, chain, num_neighbours=2)
                   for m in (TEST_MNEMONIC, M2, M3)]
        addrs = [c.signer.public_key.to_address_bytes() for c in clients]
        for i, c in enumerate(clients):
            c.attest(addrs[(i + 1) % 3], 5)

    errors = []
    for pkg, chain in _twin_chains(attest):
        client = make_client(pkg, chain=chain, num_neighbours=2)
        with pytest.raises(Exception) as e:
            client.calculate_scores(client.get_attestations())
        errors.append((type(e.value).__name__, e.value.kind, str(e.value)))
    assert errors[0] == errors[1]
    assert errors[0][:2] == ("EigenError", "validation_error")


def test_storage_roundtrips(tmp_path):
    """Each package reads what the other wrote, and writes the same
    bytes."""
    out = {}
    for name, pkg in (("ref", ref), ("port", port)):
        sig = pkg.SignatureData(b"\x01" * 32, b"\x02" * 32, 1)
        att = pkg.AttestationData(about=b"\x11" * 20, domain=DOMAIN, value=9,
                                  message=b"\x05" * 32)
        signed = pkg.SignedAttestationData(att, sig)
        record = pkg.AttestationRecord.from_signed(signed)
        pkg.CSVFileStorage(tmp_path / f"{name}-atts.csv",
                           pkg.AttestationRecord).save([record])
        pkg.CSVFileStorage(tmp_path / f"{name}-scores.csv",
                           pkg.ScoreRecord).save(
            [pkg.ScoreRecord("0xaa", "0xbb", "3", "2", "1")])
        pkg.JSONFileStorage(tmp_path / f"{name}.json").save({"a": [1, 2]})
        pkg.BinFileStorage(tmp_path / f"{name}.bin").save(b"\x00\x01")
        out[name] = signed
    for stem in ("-atts.csv", "-scores.csv", ".json", ".bin"):
        assert (tmp_path / f"port{stem}").read_bytes() == \
            (tmp_path / f"ref{stem}").read_bytes()
    loaded = port.CSVFileStorage(tmp_path / "ref-atts.csv",
                                 port.AttestationRecord).load()
    assert loaded[0].to_signed() == out["port"]
    assert port.CSVFileStorage(tmp_path / "ref-scores.csv",
                               port.ScoreRecord).load() == \
        [port.ScoreRecord("0xaa", "0xbb", "3", "2", "1")]
    from protocol_tpu_torch.utils.errors import EigenError

    with pytest.raises(EigenError):
        port.CSVFileStorage(tmp_path / "nope.csv", port.ScoreRecord).load()


# --- the batched ingest's auto mode ----------------------------------------

def _ring_attestations():
    """32 attestations among four peers, the auto mode's threshold: every
    ordered pair rated in rounds with new values (the latest of a pair
    wins), signed directly rather than through a chain. Returns them
    with their signers' addresses and public keys."""
    keys = port.ecdsa_keypairs_from_mnemonic(TEST_MNEMONIC, 4)
    addrs = [kp.public_key.to_address_bytes() for kp in keys]
    atts, signers = [], []
    for rnd in range(3):
        for i, kp in enumerate(keys):
            for j in range(4):
                if i != j and len(atts) < 32:
                    data = port.AttestationData(
                        about=addrs[j], domain=DOMAIN,
                        value=(7 * i + 3 * j + 5 * rnd) % 256)
                    sig = kp.sign(int(data.to_scalar().hash()))
                    atts.append(port.SignedAttestationData(
                        data, port.SignatureData.from_signature(sig)))
                    signers.append(kp.public_key)
    return atts, addrs, signers


def test_auto_batched_ingest_gate(monkeypatch):
    """Auto mode (``batched_ingest=None``) at 32 attestations: with no
    card the scalar path runs (``ingest.recover_scalar``); with a card
    present the attestations and the client's device go to
    ``recover_signers_batch`` and its keys make the same setup. The
    batched recovery itself is held against the scalar one by
    ``test_torch_ingest.py`` on the CPU and by ``chip_smoke.py`` phase
    ``scores`` on the card."""
    import numpy as np

    from protocol_tpu_torch.client import ingest
    from protocol_tpu_torch.utils import trace

    client_mod = importlib.import_module("protocol_tpu_torch.client.client")
    atts, addrs, signers = _ring_attestations()
    client = make_client(port)
    assert client.batched_ingest is None and len(atts) == 32

    calls = []

    def batched(attestations, full_verify=False, device=None):
        calls.append((attestations, full_verify, device))
        return (list(signers), [pk.to_address_bytes() for pk in signers],
                np.ones(len(signers), dtype=bool))

    monkeypatch.setattr(ingest, "recover_signers_batch", batched)
    was = trace.TRACER.enabled
    trace.TRACER.reset()
    trace.TRACER.enable()
    try:
        scalar = setup_fields(client.et_circuit_setup(atts))
        spans = set(trace.summary())
        assert calls == [] and "ingest.recover_scalar" in spans
        monkeypatch.setattr(client_mod, "_device_present", lambda: True)
        trace.TRACER.reset()
        with_card = setup_fields(client.et_circuit_setup(atts))
        spans = set(trace.summary())
    finally:
        trace.TRACER.reset()
        if not was:
            trace.disable()
    assert [(len(a), f, d) for a, f, d in calls] == [(32, False, "cpu")]
    assert calls[0][0] == atts and "ingest.recover_scalar" not in spans
    assert with_card == scalar
    # the last round's value stands in the matrix: 0 -> 1 rated 3, 8, 13
    i, j = (scalar["address_set"].index(addrs[k]) for k in (0, 1))
    assert scalar["matrix"][i][j][1] == 13
    # one attestation short of the threshold stays scalar, card or not
    client.et_circuit_setup(atts[:2])
    assert len(calls) == 1


def test_device_present_asks_torch():
    client_mod = importlib.import_module("protocol_tpu_torch.client.client")
    assert client_mod._device_present() == torch.cuda.is_available()


def test_rpc_chain_on_mock_node_matches_local_chain():
    """The port's MockNode runs the vendored AttestationStation bytecode:
    a client attesting through RpcChain leaves the logs that the same
    entries leave on a LocalChain, and reads its attestation back."""
    from protocol_tpu_torch.client.chain import RpcChain
    from protocol_tpu_torch.client.mocknode import MockNode

    node = MockNode()
    url = node.start()
    try:
        kp = port.ecdsa_keypairs_from_mnemonic(TEST_MNEMONIC, 1)[0]
        rpc = RpcChain.deploy_signed(url, kp)
        client = make_client(port, TEST_MNEMONIC, rpc)
        about = port.ecdsa_keypairs_from_mnemonic(M2, 1)[0] \
            .public_key.to_address_bytes()
        client.attest(about, 10)
        logs = rpc.get_logs()
        local = port.LocalChain()
        local.attest(logs[0].creator, [(g.about, g.key, g.val)
                                       for g in logs])
        assert [(g.creator, g.about, g.key, g.val) for g in logs] == \
            [(g.creator, g.about, g.key, g.val) for g in local.get_logs()]
        (att,) = client.get_attestations()
        assert (att.attestation.about, att.attestation.value) == (about, 10)
        assert rpc.get_attestation(logs[0].creator, about, logs[0].key) \
            == att.to_payload()
    finally:
        node.stop()
