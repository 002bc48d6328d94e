"""Host (exact) cryptographic oracles, copied from the reference package:
Poseidon and Rescue-Prime with their Grain constants, secp256k1 ECDSA
with the GLV split, BabyJubJub EdDSA and the Poseidon Merkle tree.
Poseidon and ECDSA are the twins of batched device implementations in
``ops``; EdDSA, Rescue-Prime and Merkle run on the host only."""

from .poseidon import Poseidon, PoseidonSponge, poseidon_params
from .rescue_prime import RescuePrime, RescuePrimeSponge, rescue_prime_params
from .edwards import EdwardsPoint, ProjectivePoint
from .eddsa import (
    EddsaPublicKey,
    EddsaSecretKey,
    EddsaSignature,
    random_keypair as eddsa_random_keypair,
    sign as eddsa_sign,
    verify as eddsa_verify,
)
from .merkle import MerklePath, MerkleTree
from .secp256k1 import (
    AffinePoint,
    EcdsaKeypair,
    EcdsaVerifier,
    PublicKey,
    Signature,
    SECP256K1_GENERATOR,
)

__all__ = [
    "Poseidon",
    "PoseidonSponge",
    "poseidon_params",
    "RescuePrime",
    "RescuePrimeSponge",
    "rescue_prime_params",
    "EdwardsPoint",
    "ProjectivePoint",
    "EddsaPublicKey",
    "EddsaSecretKey",
    "EddsaSignature",
    "eddsa_random_keypair",
    "eddsa_sign",
    "eddsa_verify",
    "MerklePath",
    "MerkleTree",
    "AffinePoint",
    "EcdsaKeypair",
    "EcdsaVerifier",
    "PublicKey",
    "Signature",
    "SECP256K1_GENERATOR",
]
