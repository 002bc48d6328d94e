"""Framework error taxonomy.

Mirrors the reference's 19-variant ``EigenError`` enum
(``eigentrust/src/error.rs``) as a single exception class with a ``kind``
discriminator, which is the Pythonic shape for the same information.
"""

from __future__ import annotations


class EigenError(Exception):
    """Error with a machine-readable ``kind`` matching the reference enum."""

    KINDS = frozenset(
        {
            "connection_error",
            "conversion_error",
            "parsing_error",
            "file_io_error",
            "attestation_error",
            "keys_error",
            "proving_error",
            "verification_error",
            "network_error",
            "contract_error",
            "config_error",
            "request_error",
            "resource_error",
            "transaction_error",
            "unknown_error",
            "validation_error",
            "read_write_error",
            "recovery_error",
            "backend_error",
            # framework-specific: circuit construction/satisfiability
            # (the reference surfaces these as halo2 VerifyFailure values)
            "circuit_error",
            # service layer (the reference's service): queue backpressure /
            # drain rejection, and the chaos seam's synthetic failures
            "service_busy",
            # the proof pool's hard byte-budget ceiling (HTTP 503, vs
            # the tiered 429 service_busy sheds)
            "over_capacity",
            "injected_fault",
        }
    )

    def __init__(self, kind: str, message: str = ""):
        if kind not in self.KINDS:
            raise ValueError(f"unknown error kind: {kind}")
        self.kind = kind
        super().__init__(f"{kind}: {message}" if message else kind)
