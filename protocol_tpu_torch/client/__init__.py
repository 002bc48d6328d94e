"""Client SDK: attestation codecs, storage, eth utils, chain access, the
Client facade (reference: the ``eigentrust`` crate), and the batched
ingest on the card (``client.ingest``). The port's copy of the
reference package's client; only the Client's device seams differ."""

from .attestation import (
    DOMAIN_PREFIX,
    AttestationData,
    SignatureData,
    SignedAttestationData,
)
from .storage import (
    AttestationRecord,
    BinFileStorage,
    CSVFileStorage,
    JSONFileStorage,
    ScoreRecord,
    Storage,
)
from .eth import (
    address_from_public_key,
    ecdsa_keypairs_from_mnemonic,
    scalar_from_address,
)
from .chain import AttestationStation, LocalChain, RpcChain
from .circuit_io import ETPublicInputs, ETSetup, Score, ThPublicInputs, ThSetup
from .client import Client, ClientConfig

__all__ = [
    "DOMAIN_PREFIX",
    "AttestationData",
    "SignatureData",
    "SignedAttestationData",
    "AttestationRecord",
    "BinFileStorage",
    "CSVFileStorage",
    "JSONFileStorage",
    "ScoreRecord",
    "Storage",
    "address_from_public_key",
    "ecdsa_keypairs_from_mnemonic",
    "scalar_from_address",
    "AttestationStation",
    "LocalChain",
    "RpcChain",
    "ETPublicInputs",
    "ETSetup",
    "Score",
    "ThPublicInputs",
    "ThSetup",
    "Client",
    "ClientConfig",
]
