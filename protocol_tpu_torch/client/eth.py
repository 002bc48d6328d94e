"""Ethereum utilities: BIP-39/32 key derivation, address/scalar
conversions, RLP, and legacy transaction signing.

Mirrors ``eigentrust/src/eth.rs``: the 44'/60'/0'/0/i derivation path
(ecdsa_keypairs_from_mnemonic), ``address_from_ecdsa_key`` and
``scalar_from_address``. The reference leans on ethers-rs for BIP-32 and
transaction plumbing; here the primitives are implemented directly on the
standard library (PBKDF2/HMAC-SHA512) and our secp256k1 oracle.
"""

from __future__ import annotations

import hashlib
import hmac

from ..crypto.secp256k1 import EcdsaKeypair, PublicKey, SECP256K1_GENERATOR, N
from ..utils.errors import EigenError
from ..utils.fields import Fr
from ..utils.keccak import keccak256

_HARDENED = 0x8000_0000


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    """BIP-39 seed: PBKDF2-HMAC-SHA512 over the NFKD phrase, 2048 rounds."""
    import unicodedata

    phrase = unicodedata.normalize("NFKD", mnemonic.strip())
    salt = unicodedata.normalize("NFKD", "mnemonic" + passphrase)
    return hashlib.pbkdf2_hmac("sha512", phrase.encode(), salt.encode(), 2048)


def _ckd_priv(k: int, chain_code: bytes, index: int) -> tuple:
    """BIP-32 child key derivation (private parent → private child)."""
    if index >= _HARDENED:
        data = b"\x00" + k.to_bytes(32, "big") + index.to_bytes(4, "big")
    else:
        point = SECP256K1_GENERATOR.mul(k)
        prefix = bytes([2 + (point.y & 1)])
        data = prefix + point.x.to_bytes(32, "big") + index.to_bytes(4, "big")
    digest = hmac.new(chain_code, data, hashlib.sha512).digest()
    child = (int.from_bytes(digest[:32], "big") + k) % N
    if child == 0:
        raise EigenError("keys_error", "degenerate child key")
    return child, digest[32:]


def derive_private_key(seed: bytes, path: list) -> int:
    """Derive along a BIP-32 path (ints, hardened = i + 0x80000000)."""
    digest = hmac.new(b"Bitcoin seed", seed, hashlib.sha512).digest()
    k, chain_code = int.from_bytes(digest[:32], "big"), digest[32:]
    for index in path:
        k, chain_code = _ckd_priv(k, chain_code, index)
    return k


def ecdsa_keypairs_from_mnemonic(mnemonic: str, count: int) -> list:
    """Keypairs along 44'/60'/0'/0/i (eth.rs:28-67)."""
    seed = mnemonic_to_seed(mnemonic)
    keys = []
    for i in range(count):
        path = [44 + _HARDENED, 60 + _HARDENED, _HARDENED, 0, i]
        keys.append(EcdsaKeypair(derive_private_key(seed, path)))
    return keys


def address_from_public_key(pub_key: PublicKey) -> bytes:
    """20-byte Ethereum address (eth.rs address_from_ecdsa_key)."""
    return pub_key.to_address_bytes()


def scalar_from_address(address: bytes) -> Fr:
    """Address bytes → Fr via the LE embedding (eth.rs:77-95)."""
    if len(address) != 20:
        raise EigenError("conversion_error", "address must be 20 bytes")
    return Fr.from_bytes_le(address[::-1] + b"\x00" * 12)


# --- RLP + legacy (EIP-155) transaction signing --------------------------


def rlp_encode(item) -> bytes:
    """Minimal RLP: bytes, ints (big-endian minimal), and lists."""
    if isinstance(item, int):
        item = b"" if item == 0 else item.to_bytes((item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _rlp_len(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _rlp_len(len(payload), 0xC0) + payload
    raise EigenError("conversion_error", f"cannot RLP-encode {type(item)}")


def _rlp_len(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    len_bytes = length.to_bytes((length.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(len_bytes)]) + len_bytes


def sign_legacy_tx(
    keypair: EcdsaKeypair,
    nonce: int,
    gas_price: int,
    gas: int,
    to: bytes,
    value: int,
    data: bytes,
    chain_id: int,
) -> bytes:
    """EIP-155 signed legacy transaction, RLP-encoded raw bytes."""
    sighash = keccak256(
        rlp_encode([nonce, gas_price, gas, to, value, data, chain_id, 0, 0])
    )
    sig = keypair.sign(int.from_bytes(sighash, "big"))
    v = 35 + chain_id * 2 + sig.rec_id
    return rlp_encode([nonce, gas_price, gas, to, value, data, v, sig.r, sig.s])
