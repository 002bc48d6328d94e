"""File persistence: CSV / JSON / binary storage with typed records.

Mirrors the reference's ``Storage`` trait and implementations
(``eigentrust/src/storage.rs``): CSVFileStorage (serde records),
JSONFileStorage, BinFileStorage, plus the two record types with identical
column names and hex-string conventions so CSV files round-trip between
the two frameworks.
"""

from __future__ import annotations

import csv
import json
from abc import ABC, abstractmethod
from dataclasses import asdict, dataclass, fields
from pathlib import Path

from ..utils.errors import EigenError


class Storage(ABC):
    """load/save pair (storage.rs:25-33)."""

    @abstractmethod
    def load(self):
        ...

    @abstractmethod
    def save(self, data) -> None:
        ...


class CSVFileStorage(Storage):
    """CSV persistence of a list of dataclass records."""

    def __init__(self, path, record_type):
        self.path = Path(path)
        self.record_type = record_type

    def load(self) -> list:
        try:
            with open(self.path, newline="") as f:
                reader = csv.DictReader(f)
                names = {f.name for f in fields(self.record_type)}
                out = []
                for row in reader:
                    extra = set(row) - names
                    missing = names - set(row)
                    if extra or missing:
                        raise EigenError(
                            "parsing_error",
                            f"CSV columns mismatch: extra={sorted(extra)}"
                            f" missing={sorted(missing)}",
                        )
                    if any(v is None for v in row.values()):
                        raise EigenError("parsing_error", "short CSV row")
                    out.append(self.record_type(**row))
                return out
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e

    def save(self, data: list) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w", newline="") as f:
                writer = csv.DictWriter(
                    f, fieldnames=[fld.name for fld in fields(self.record_type)]
                )
                writer.writeheader()
                for record in data:
                    writer.writerow(asdict(record))
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e


class JSONFileStorage(Storage):
    """JSON persistence of any json-serializable value (storage.rs:112-144)."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self):
        try:
            with open(self.path) as f:
                return json.load(f)
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e
        except json.JSONDecodeError as e:
            raise EigenError("parsing_error", str(e)) from e

    def save(self, data) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(data, f, indent=2)
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e


class BinFileStorage(Storage):
    """Raw bytes persistence (storage.rs:148-180) — kzg params, keys,
    proofs."""

    def __init__(self, path):
        self.path = Path(path)

    def load(self) -> bytes:
        try:
            return self.path.read_bytes()
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e

    def save(self, data: bytes) -> None:
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_bytes(bytes(data))
        except OSError as e:
            raise EigenError("file_io_error", str(e)) from e


@dataclass
class ScoreRecord:
    """One scores.csv row (storage.rs:183-243); all values strings with the
    reference's conventions (0x-hex address/score_fr, decimal num/den)."""

    peer_address: str
    score_fr: str
    numerator: str
    denominator: str
    score: str

    @classmethod
    def from_score(cls, score) -> "ScoreRecord":
        """From a circuit_io.Score."""
        return cls(
            peer_address="0x" + score.address.hex(),
            score_fr="0x" + score.score_fr.hex(),
            numerator=str(score.numerator),
            denominator=str(score.denominator),
            score=str(score.score_int),
        )


@dataclass
class AttestationRecord:
    """One attestations.csv row (storage.rs:246-307)."""

    about: str
    domain: str
    value: str
    message: str
    sig_r: str
    sig_s: str
    rec_id: str

    @classmethod
    def from_signed(cls, signed) -> "AttestationRecord":
        """From a client.attestation.SignedAttestationData."""
        return cls(
            about="0x" + signed.attestation.about.hex(),
            domain="0x" + signed.attestation.domain.hex(),
            value=str(signed.attestation.value),
            message="0x" + signed.attestation.message.hex(),
            sig_r="0x" + signed.signature.r.hex(),
            sig_s="0x" + signed.signature.s.hex(),
            rec_id=str(signed.signature.rec_id),
        )

    def to_signed(self):
        from .attestation import AttestationData, SignatureData, SignedAttestationData

        def unhex(s: str, length: int) -> bytes:
            raw = bytes.fromhex(s.removeprefix("0x"))
            if len(raw) != length:
                raise EigenError("parsing_error", f"expected {length} bytes, got {len(raw)}")
            return raw

        try:
            att = AttestationData(
                about=unhex(self.about, 20),
                domain=unhex(self.domain, 20),
                value=int(self.value),
                message=unhex(self.message, 32),
            )
            sig = SignatureData(
                r=unhex(self.sig_r, 32), s=unhex(self.sig_s, 32), rec_id=int(self.rec_id)
            )
        except ValueError as e:
            raise EigenError("parsing_error", str(e)) from e
        return SignedAttestationData(att, sig)
