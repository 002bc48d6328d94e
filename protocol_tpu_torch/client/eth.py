"""Ethereum address derivation (the part of the reference's
``client/eth.py`` that ingest needs; ``eigentrust/src/eth.rs``
``address_from_ecdsa_key``)."""

from __future__ import annotations

from ..crypto.secp256k1 import PublicKey


def address_from_public_key(pub_key: PublicKey) -> bytes:
    """20-byte Ethereum address (eth.rs address_from_ecdsa_key)."""
    return pub_key.to_address_bytes()
