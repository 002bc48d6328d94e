"""File layout: assets directory, artifact naming, secrets.

Mirrors ``eigentrust-cli/src/fs.rs``: the EigenFile naming scheme
(kzg-params-{k}.bin, {et|th}-proving-key.bin, {et|th}-proof.bin,
{et|th}-public-inputs.bin), assets-dir resolution, and the MNEMONIC env
secret with an insecure development default.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..utils.errors import EigenError

# well-known development mnemonic (same spirit as the reference's insecure
# default, fs.rs:87-93 — never use with real funds)
INSECURE_MNEMONIC = "test test test test test test test test test test test junk"


def assets_dir(override: str | None = None) -> Path:
    """Assets dir: --assets flag > EIGEN_ASSETS env > ./assets."""
    path = Path(override or os.environ.get("EIGEN_ASSETS", "assets"))
    path.mkdir(parents=True, exist_ok=True)
    return path


def load_mnemonic() -> str:
    """MNEMONIC env with insecure default (warns via return contract)."""
    return os.environ.get("MNEMONIC", INSECURE_MNEMONIC)


class EigenFile:
    """Artifact path naming (fs.rs:50-84)."""

    def __init__(self, assets: Path):
        self.assets = assets

    def kzg_params(self, k: int) -> Path:
        return self.assets / f"kzg-params-{k}.bin"

    def et_proving_key(self) -> Path:
        return self.assets / "et-proving-key.bin"

    def th_proving_key(self) -> Path:
        return self.assets / "th-proving-key.bin"

    def et_proof(self) -> Path:
        return self.assets / "et-proof.bin"

    def et_verifier(self) -> Path:
        return self.assets / "et-verifier.yul"

    def et_proof_meta(self) -> Path:
        """Sidecar recording how et-proof.bin was produced (transcript
        kind) so verify verbs can't silently replay the wrong hash."""
        return self.assets / "et-proof.meta.json"

    def et_public_inputs(self) -> Path:
        return self.assets / "et-public-inputs.bin"

    def th_proof(self) -> Path:
        return self.assets / "th-proof.bin"

    def th_public_inputs(self) -> Path:
        return self.assets / "th-public-inputs.bin"

    def attestations_csv(self) -> Path:
        return self.assets / "attestations.csv"

    def scores_csv(self) -> Path:
        return self.assets / "scores.csv"

    def config_json(self) -> Path:
        return self.assets / "config.json"

    def chain_json(self) -> Path:
        return self.assets / "chain.json"

    def service_state_dir(self) -> Path:
        """Root of the serve daemon's durable state store (WAL, graph
        snapshots, operator cache, block cursor); both packages share
        this layout and its file formats."""
        return self.assets / "service-state"

    def proofs_dir(self) -> Path:
        """Persisted proof artifacts, one directory per job id with the
        stable file names ``proof.bin`` / ``public-inputs.bin`` /
        ``job.json`` (the service twin of ``et_proof()`` and friends)."""
        return self.assets / "proofs"

    def read(self, path: Path) -> bytes:
        if not path.exists():
            raise EigenError("file_io_error", f"missing artifact: {path}")
        return path.read_bytes()
