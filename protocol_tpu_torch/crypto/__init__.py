"""Host (exact) cryptographic oracles, copied from the reference package:
Poseidon and its Grain constants, secp256k1 ECDSA with the GLV split.
Each is the twin of a batched device implementation in ``ops``."""
