"""The port's EVM verifier against the JAX package's: the Yul text
generated from one key, the Yul interpreter's output and yellow-paper
gas on the same calldata, the calldata encoder, and the port's devnet
(``client.mocknode``) running a deployed verifier on-chain.

The snark is a small real one (k = 8) whose public inputs follow the
two-peer EigenTrust layout (participants ‖ scores ‖ domain ‖ opinion
hash), proved by the port under each transcript; the reference reads
the same params, key and proof bytes. Twins of
``tests/test_evm_verifier.py``.
"""

import pytest

from protocol_tpu.zk import api as ref_api
from protocol_tpu.zk import evm as ref_evm
from protocol_tpu.zk import yul as ref_yul
from protocol_tpu.zk.kzg import KZGParams as RefParams
from protocol_tpu.zk.plonk import ProvingKey as RefProvingKey
from protocol_tpu_torch.client.circuit_io import ETPublicInputs
from protocol_tpu_torch.utils.fields import Fr
from protocol_tpu_torch.zk import api as port_api
from protocol_tpu_torch.zk import evm
from protocol_tpu_torch.zk import yul
from protocol_tpu_torch.zk.gadgets import Chips
from protocol_tpu_torch.zk.kzg import KZGParams
from protocol_tpu_torch.zk.plonk import ConstraintSystem, keygen, prove

TINY = port_api.TINY_SHAPE
ADDRS, SCORES = [11, 22], [700, 1300]


@pytest.fixture(scope="module")
def artifacts():
    """{transcript: (params bytes, pk bytes, public-input bytes, proof)}
    and the parsed port and reference (params, pk) of the one key."""
    pubs = ADDRS + SCORES + [42, 12345]
    c = Chips(ConstraintSystem(lookup_bits=4))
    x, y = c.witness(3), c.witness(4)
    s = c.add(x, y)
    c.lincomb([(2, x), (3, y), (1, s), (1, c.mul(x, y))], const=1)
    c.mul_add(x, y, s)
    c.range_check(c.witness(9), 4)
    c.cs.add_row([0, 0, 2, 3, 0, 0], q_mul_cd=1, q_const=-6)
    for v in pubs:
        c.cs.public_input(v)
    c.cs.check_satisfied()
    params_b = port_api.generate_kzg_params(8, seed=b"cli-evm")
    params = KZGParams.from_bytes(params_b)
    pk = keygen(params, c.cs)
    pk_b = pk.to_bytes()
    pub_b = ETPublicInputs(participants=[Fr(a) for a in ADDRS],
                           scores=[Fr(v) for v in SCORES], domain=Fr(42),
                           opinion_hash=Fr(12345)).to_bytes()
    out = {tr: (params_b, pk_b, pub_b,
                prove(params, pk, c.cs, transcript=tr))
           for tr in ("keccak", "poseidon")}
    return out, (params, pk), (RefParams.from_bytes(params_b),
                               RefProvingKey.from_bytes(pk_b))


@pytest.mark.parametrize("transcript", ["keccak", "poseidon"])
def test_yul_text_equals_reference(artifacts, transcript):
    arts, (params, pk), (ref_params, ref_pk) = artifacts
    params_b, pk_b, _, _ = arts[transcript]
    code = port_api.gen_et_evm_verifier(params_b, pk_b, transcript=transcript)
    assert code == ref_api.gen_et_evm_verifier(params_b, pk_b,
                                               transcript=transcript)
    assert code == evm.gen_evm_verifier_code(params, pk,
                                             transcript=transcript)
    assert code == ref_evm.gen_evm_verifier_code(ref_params, ref_pk,
                                                 transcript=transcript)
    assert 'object "PlonkVerifier"' in code


@pytest.mark.parametrize("transcript", ["keccak", "poseidon"])
def test_vm_output_and_gas_equal_reference(artifacts, transcript):
    arts, *_ = artifacts
    params_b, pk_b, pub_b, proof = arts[transcript]
    calldata = port_api.et_evm_calldata(pub_b, proof, shape=TINY)
    assert calldata == ref_api.et_evm_calldata(pub_b, proof,
                                               shape=ref_api.TINY_SHAPE)
    code = port_api.gen_et_evm_verifier(params_b, pk_b, transcript=transcript)
    out, gas = yul.YulVM(code).run(calldata)
    assert (out, gas) == ref_yul.YulVM(code).run(calldata)
    assert int.from_bytes(out, "big") == 1
    assert yul.YulVM(code).run_tx(calldata) == \
        ref_yul.YulVM(code).run_tx(calldata)
    assert 100_000 < gas < 10_000_000


@pytest.mark.parametrize("section", ["instance", "point", "w"])
def test_tampered_calldata_rejected_by_both(artifacts, section):
    arts, *_ = artifacts
    params_b, pk_b, pub_b, proof = arts["keccak"]
    calldata = bytearray(port_api.et_evm_calldata(pub_b, proof, shape=TINY))
    offset = {"instance": 31, "point": 32 * 6 + 16,
              "w": len(calldata) - 100}[section]
    calldata[offset] ^= 1
    code = port_api.gen_et_evm_verifier(params_b, pk_b)
    assert evm.evm_verify(code, bytes(calldata)) == \
        ref_evm.evm_verify(code, bytes(calldata))
    assert not evm.evm_verify(code, bytes(calldata))[0]


def test_transcript_mismatch_rejected(artifacts):
    """A poseidon proof does not pass the keccak verifier."""
    arts, *_ = artifacts
    params_b, pk_b, pub_b, proof = arts["poseidon"]
    code = port_api.gen_et_evm_verifier(params_b, pk_b, transcript="keccak")
    calldata = port_api.et_evm_calldata(pub_b, proof, shape=TINY)
    assert not evm.evm_verify(code, calldata)[0]


# small programs with hand-derived yellow-paper gas (the reference's
# TestYellowPaperSchedule / TestYulInterpreter fixtures)
PROGRAMS = {
    "known_gas": ("""{
        let x := calldataload(4)
        mstore(64, x)
        let h := keccak256(64, 32)
        mstore(96, mulmod(h, x, 7))
        return(96, 32)
    }""", b"\x00" * 36),
    "memory_expansion": ("{ mstore(65504, 1) }", b""),
    "loop_break": ("""{
        let acc := 0
        for { let i := 0 } lt(i, 100) { i := add(i, 1) } {
            if eq(i, 5) { break }
            acc := add(acc, i)
        }
        mstore(0, acc) return(0, 32) }""", b""),
    "modexp": ("""{
        mstore(0, 32) mstore(32, 32) mstore(64, 32)
        mstore(96, 5) mstore(128, 3) mstore(160, 97)
        pop(staticcall(gas(), 5, 0, 192, 0, 32))
        return(0, 32) }""", b""),
    "ec_precompiles": ("""{
        mstore(0, 1) mstore(32, 2) mstore(64, 5)
        pop(staticcall(gas(), 7, 0, 96, 0, 64))
        mstore(64, 1) mstore(96, 2)
        pop(staticcall(gas(), 6, 0, 128, 0, 64))
        return(0, 64) }""", b""),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_interpreter_programs_equal_reference(name):
    src, calldata = PROGRAMS[name]
    got = yul.YulVM(src).run(calldata)
    assert got == ref_yul.YulVM(src).run(calldata)
    assert yul.YulVM(src).run_tx(calldata) == \
        ref_yul.YulVM(src).run_tx(calldata)
    if name == "known_gas":
        assert got[1] == 98
    if name == "memory_expansion":
        assert got[1] == 14345


def test_revert_raises_in_both():
    src = "{ if lt(calldataload(0), 10) { revert(0, 0) } mstore(0, 1) " \
          "return(0, 32) }"
    for vm_mod in (yul, ref_yul):
        with pytest.raises(vm_mod.VMRevert):
            vm_mod.YulVM(src).run((5).to_bytes(32, "big"))
    assert yul.YulVM(src).run((11).to_bytes(32, "big")) == \
        ref_yul.YulVM(src).run((11).to_bytes(32, "big"))


def test_mocknode_runs_a_deployed_verifier(artifacts):
    """The port's devnet executes the verifier on-chain: VALID with the
    gas the interpreter replays plus the transaction's, INVALID on a
    tampered proof (an ``eth_call`` revert)."""
    from protocol_tpu_torch.cli.fs import INSECURE_MNEMONIC
    from protocol_tpu_torch.client.chain import VerifierContract
    from protocol_tpu_torch.client.eth import ecdsa_keypairs_from_mnemonic
    from protocol_tpu_torch.client.mocknode import MockNode

    arts, *_ = artifacts
    params_b, pk_b, pub_b, proof = arts["keccak"]
    code = port_api.gen_et_evm_verifier(params_b, pk_b)
    calldata = port_api.et_evm_calldata(pub_b, proof, shape=TINY)
    kp = ecdsa_keypairs_from_mnemonic(INSECURE_MNEMONIC, 1)[0]
    node = MockNode()
    url = node.start()
    try:
        contract = VerifierContract.deploy_signed(url, kp, code)
        assert contract.verify(calldata)
        assert contract.estimate_gas(calldata) == \
            yul.YulVM(code).run_tx(calldata)[1]
        bad = bytearray(proof)
        bad[100] ^= 1
        assert not contract.verify(
            port_api.et_evm_calldata(pub_b, bytes(bad), shape=TINY))
    finally:
        node.stop()
