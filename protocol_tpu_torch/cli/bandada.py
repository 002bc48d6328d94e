"""Bandada REST client: threshold-gated Semaphore group membership.

Mirrors ``eigentrust-cli/src/bandada.rs``: POST/DELETE
``{base}/groups/{id}/members/{commitment}`` with the X-API-KEY header
sourced from the BANDADA_API_KEY env var.
"""

from __future__ import annotations

import os
import urllib.request

from ..utils.errors import EigenError


class BandadaApi:
    def __init__(self, base_url: str, api_key: str | None = None):
        self.base_url = base_url.rstrip("/")
        self.api_key = api_key or os.environ.get("BANDADA_API_KEY", "")
        if not self.api_key:
            raise EigenError("config_error", "BANDADA_API_KEY is not set")

    def _request(self, method: str, group_id: str, commitment: str) -> None:
        url = f"{self.base_url}/groups/{group_id}/members/{commitment}"
        req = urllib.request.Request(
            url, method=method, headers={"X-API-KEY": self.api_key}
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                if resp.status >= 300:
                    raise EigenError("request_error", f"{method} {url}: {resp.status}")
        except OSError as e:
            raise EigenError("connection_error", f"{method} {url}: {e}") from e

    def add_member(self, group_id: str, commitment: str) -> None:
        self._request("POST", group_id, commitment)

    def remove_member(self, group_id: str, commitment: str) -> None:
        self._request("DELETE", group_id, commitment)
