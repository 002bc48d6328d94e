"""The port's EdDSA, Rescue-Prime and Merkle layer (``crypto/edwards``,
``crypto/eddsa``, ``crypto/rescue_prime`` with its table,
``crypto/merkle`` and the ``zk`` chips over them) held to the
reference's on the CPU: seeded signatures, hashes and Merkle paths equal
value for value, the Rescue table's spot values, and one circuit per
chip with the reference's rows, satisfied, and unsatisfied after one
flipped witness. These modules run on the host only, in both
packages."""

import random

import pytest

from protocol_tpu.crypto import eddsa as ref_eddsa
from protocol_tpu.crypto import merkle as ref_merkle
from protocol_tpu.crypto import poseidon as ref_poseidon
from protocol_tpu.crypto import rescue_prime as ref_rescue
from protocol_tpu.utils.fields import Fr as RefFr
from protocol_tpu.zk import eddsa_chip as ref_eddsa_chip
from protocol_tpu.zk import gadgets as ref_gadgets
from protocol_tpu.zk import merkle_chip as ref_merkle_chip
from protocol_tpu.zk import rescue_chip as ref_rescue_chip
from protocol_tpu_torch import crypto as port_crypto
from protocol_tpu_torch.crypto import eddsa as port_eddsa
from protocol_tpu_torch.crypto import merkle as port_merkle
from protocol_tpu_torch.crypto import poseidon as port_poseidon
from protocol_tpu_torch.crypto import rescue_prime as port_rescue
from protocol_tpu_torch.utils.errors import EigenError
from protocol_tpu_torch.utils.fields import Fr as PortFr
from protocol_tpu_torch.zk import eddsa_chip as port_eddsa_chip
from protocol_tpu_torch.zk import gadgets as port_gadgets
from protocol_tpu_torch.zk import merkle_chip as port_merkle_chip
from protocol_tpu_torch.zk import rescue_chip as port_rescue_chip


class _Pkg:
    def __init__(self, **mods):
        self.__dict__.update(mods)


REF = _Pkg(Fr=RefFr, eddsa=ref_eddsa, merkle=ref_merkle,
           poseidon=ref_poseidon, rescue=ref_rescue,
           eddsa_chip=ref_eddsa_chip, gadgets=ref_gadgets,
           merkle_chip=ref_merkle_chip, rescue_chip=ref_rescue_chip)
PORT = _Pkg(Fr=PortFr, eddsa=port_eddsa, merkle=port_merkle,
            poseidon=port_poseidon, rescue=port_rescue,
            eddsa_chip=port_eddsa_chip, gadgets=port_gadgets,
            merkle_chip=port_merkle_chip, rescue_chip=port_rescue_chip)


def _sig_ints(pkg, seed: bytes, message: int):
    sk = pkg.eddsa.EddsaSecretKey.from_byte_array(seed)
    pk = sk.public()
    sig = pkg.eddsa.sign(sk, pk, pkg.Fr(message))
    assert pkg.eddsa.verify(sig, pk, pkg.Fr(message))
    assert not pkg.eddsa.verify(sig, pk, pkg.Fr(message + 1))
    return (pk.point.x, pk.point.y, sig.big_r.x, sig.big_r.y, sig.s)


def test_signatures_equal_the_reference():
    rng = random.Random(0xEDD5)
    for _ in range(3):
        seed = rng.randbytes(32)
        message = rng.randrange(RefFr.MODULUS)
        assert _sig_ints(PORT, seed, message) == _sig_ints(REF, seed,
                                                           message)


def test_rescue_hashes_equal_the_reference():
    rng = random.Random(0x5E5C)
    for n in (5, 7, 12):
        vals = [rng.randrange(RefFr.MODULUS) for _ in range(n)]
        sponges = []
        for pkg in (PORT, REF):
            sp = pkg.rescue.RescuePrimeSponge()
            sp.update([pkg.Fr(v) for v in vals])
            perm = pkg.rescue.RescuePrime(
                [pkg.Fr(v) for v in vals[:5]]).permute()
            sponges.append((int(sp.squeeze()), [int(x) for x in perm]))
        assert sponges[0] == sponges[1]


def test_rescue_table_spot_values():
    """Twin of the reference's ``test_rescue_5x5_table_spot_values``,
    and the whole table equal to the reference's."""
    rc, mds, inv5 = port_rescue.rescue_prime_params(5, PortFr.MODULUS)
    assert len(rc) == 8 * 5
    assert rc[0] == 0x2CA4A8F397401B89877423695357441AA6F56488841DB4B55FFB8D911B947E44
    assert pow(pow(3, 5, PortFr.MODULUS), inv5, PortFr.MODULUS) == 3
    ref = ref_rescue.rescue_prime_params(5, RefFr.MODULUS)
    assert ([int(v) for v in rc], [[int(v) for v in r] for r in mds], inv5) \
        == ([int(v) for v in ref[0]], [[int(v) for v in r] for r in ref[1]],
            ref[2])


@pytest.mark.parametrize("arity,height,count,hasher", [
    (2, 3, 8, "poseidon"), (3, 3, 20, "poseidon"), (4, 2, 16, "poseidon"),
    (2, 2, 4, "rescue")])
def test_merkle_paths_equal_the_reference(arity, height, count, hasher):
    rng = random.Random(arity * 100 + height)
    leaves = [rng.randrange(RefFr.MODULUS) for _ in range(count)]
    index = rng.randrange(count)
    out = []
    for pkg in (PORT, REF):
        h = (pkg.poseidon.Poseidon if hasher == "poseidon"
             else pkg.rescue.RescuePrime)
        tree = pkg.merkle.MerkleTree([pkg.Fr(v) for v in leaves],
                                     height=height, arity=arity, hasher=h)
        path = pkg.merkle.MerklePath.find_path(tree, index)
        assert path.verify()
        out.append((int(tree.root), int(path.value),
                    [[int(v) for v in row] for row in path.path_arr]))
    assert out[0] == out[1]


def test_crypto_exports_match_the_reference():
    import protocol_tpu.crypto as ref_crypto

    assert port_crypto.__all__ == ref_crypto.__all__
    for name in port_crypto.__all__:
        port, ref = getattr(port_crypto, name), getattr(ref_crypto, name)
        assert type(port).__name__ == type(ref).__name__
        assert getattr(port, "__qualname__", None) == \
            getattr(ref, "__qualname__", None)


# --- one circuit per chip -------------------------------------------------------

def _eddsa_circuit(pkg):
    sk = pkg.eddsa.EddsaSecretKey.from_byte_array(b"chip-seed")
    pk = sk.public()
    msg = pkg.Fr(777777)
    sig = pkg.eddsa.sign(sk, pk, msg)
    c = pkg.gadgets.Chips()
    pkg.eddsa_chip.EddsaChip(c).verify(sig.big_r.x, sig.big_r.y, sig.s,
                                       pk.point.x, pk.point.y, int(msg))
    return c


def _rescue_circuit(pkg):
    c = pkg.gadgets.Chips()
    chip = pkg.rescue_chip.RescuePrimeChip(c)
    out = chip.permute([c.witness(i) for i in range(5)])
    native = pkg.rescue.RescuePrime([pkg.Fr(i) for i in range(5)]).permute()
    assert [c.value(o) for o in out] == [int(v) for v in native]
    sp = pkg.rescue_chip.RescuePrimeSpongeChip(c)
    vals = (3, 1, 4, 1, 5, 9, 2, 6)
    sp.update([c.witness(v) for v in vals])
    native_sp = pkg.rescue.RescuePrimeSponge()
    native_sp.update([pkg.Fr(v) for v in vals])
    assert c.value(sp.squeeze()) == int(native_sp.squeeze())
    return c


def _merkle_circuit(pkg):
    leaves = [pkg.Fr(v) for v in (5, 9, 12, 33, 2, 7, 11, 90)]
    tree = pkg.merkle.MerkleTree(leaves, height=3, arity=2)
    path = pkg.merkle.MerklePath.find_path(tree, 5)
    c = pkg.gadgets.Chips()
    root = pkg.merkle_chip.MerklePathChip(c, arity=2).verify(path)
    assert c.value(root) == int(tree.root)
    return c


@pytest.mark.parametrize("build", [_eddsa_circuit, _rescue_circuit,
                                   _merkle_circuit],
                         ids=["eddsa", "rescue", "merkle"])
def test_chip_circuit_equals_the_reference(build):
    port, ref = build(PORT).cs, build(REF).cs
    assert port.num_rows > 0
    assert port.wires == ref.wires
    port.check_satisfied()
    row = port.num_rows // 2
    port.wires[0][row] = (port.wires[0][row] + 1) % PortFr.MODULUS
    with pytest.raises(EigenError):
        port.check_satisfied()
