"""Chain access: the AttestationStation contract surface.

Two implementations of one interface (the reference binds the real
contract via ethers-rs abigen, ``eigentrust/src/att_station.rs``):

- :class:`LocalChain` — in-process simulation of the AttestationStation
  semantics (attestations mapping + AttestationCreated logs). This is the
  framework's fast "fake backend" for tests and local development; the
  reference's equivalent is spawning a real Anvil devnet per test
  (SURVEY.md §4 layer 5).
- :class:`RpcChain` — a JSON-RPC client (eth_getLogs / raw-tx submission)
  speaking to a real node, with hand-rolled ABI coding for
  ``attest((address,bytes32,bytes)[])`` and the
  ``AttestationCreated(address,address,bytes32,bytes)`` event.
"""

from __future__ import annotations

import json
import time
import urllib.request
from dataclasses import dataclass

from ..utils.errors import EigenError
from ..utils.keccak import keccak256

# event AttestationCreated(address indexed creator, address indexed about,
#                          bytes32 indexed key, bytes val)
EVENT_SIGNATURE = "AttestationCreated(address,address,bytes32,bytes)"
EVENT_TOPIC = "0x" + keccak256(EVENT_SIGNATURE.encode()).hex()
ATTEST_SELECTOR = keccak256(b"attest((address,bytes32,bytes)[])")[:4]
ATTESTATIONS_SELECTOR = keccak256(
    b"attestations(address,address,bytes32)")[:4]


def _await_deploy_receipt(rpc, txh: str, created: bytes,
                          receipt_timeout: float = 120.0) -> None:
    """Poll for a contract-creation receipt and validate it.

    Without this, a rejected creation surfaces much later as reads
    against a missing contract (eth_call returns 0x — e.g. a valid
    proof misreported as rejected). Real nodes return null until the
    tx is mined — poll up to receipt_timeout (default covers several
    ~12 s blocks; raise it for congested networks); the mock devnet
    mines synchronously, so the first poll hits. A timeout is reported
    as 'possibly still pending', distinct from an executed-and-failed
    (status != 0x1) deploy, so callers don't blindly re-deploy and pay
    gas twice."""
    deadline = time.monotonic() + receipt_timeout
    while True:
        receipt = rpc("eth_getTransactionReceipt", [txh])
        if receipt or time.monotonic() >= deadline:
            break
        time.sleep(min(2.0, max(0.1, receipt_timeout / 60)))
    if not receipt:
        raise EigenError(
            "transaction_error",
            f"no deploy receipt for {txh} after {receipt_timeout:.0f}s; "
            "the creation tx may still be pending — do not re-send "
            "without checking the nonce")
    if receipt.get("status") != "0x1":
        raise EigenError(
            "transaction_error",
            f"contract deploy reverted (receipt={receipt!r})")
    got = receipt.get("contractAddress")
    if got and bytes.fromhex(got.removeprefix("0x")) != created:
        raise EigenError(
            "transaction_error",
            f"deploy address mismatch: {got} != 0x{created.hex()}")


@dataclass
class AttestationLog:
    """One decoded AttestationCreated event."""

    creator: bytes  # 20
    about: bytes  # 20
    key: bytes  # 32
    val: bytes
    block_number: int = 0


class AttestationStation:
    """Interface both chains implement."""

    def attest(self, creator: bytes, entries: list) -> str:
        """entries: [(about20, key32, payload_bytes)]; returns tx hash."""
        raise NotImplementedError

    def get_attestation(self, creator: bytes, about: bytes, key: bytes) -> bytes:
        raise NotImplementedError

    def get_logs(self, from_block: int = 0) -> list:
        raise NotImplementedError


class LocalChain(AttestationStation):
    """In-memory AttestationStation with contract-equivalent semantics."""

    def __init__(self):
        self.store: dict = {}  # (creator, about, key) -> val
        self.logs: list = []
        self.block = 0

    def attest(self, creator: bytes, entries: list) -> str:
        self.block += 1
        for about, key, val in entries:
            self.store[(creator, about, key)] = val
            self.logs.append(
                AttestationLog(creator, about, key, val, self.block)
            )
        digest = keccak256(
            creator + b"".join(a + k + v for a, k, v in entries)
        )
        return "0x" + digest.hex()

    def get_attestation(self, creator: bytes, about: bytes, key: bytes) -> bytes:
        return self.store.get((creator, about, key), b"")

    def get_logs(self, from_block: int = 0) -> list:
        return [log for log in self.logs if log.block_number >= from_block]

    # -- persistence (lets the CLI run a durable local chain without a
    # node; the reference's equivalent is an external Anvil devnet) -------
    def to_json(self) -> dict:
        return {
            "block": self.block,
            "logs": [
                {
                    "creator": log.creator.hex(),
                    "about": log.about.hex(),
                    "key": log.key.hex(),
                    "val": log.val.hex(),
                    "block_number": log.block_number,
                }
                for log in self.logs
            ],
        }

    @classmethod
    def from_json(cls, data: dict) -> "LocalChain":
        chain = cls()
        chain.block = data.get("block", 0)
        for row in data.get("logs", []):
            log = AttestationLog(
                creator=bytes.fromhex(row["creator"]),
                about=bytes.fromhex(row["about"]),
                key=bytes.fromhex(row["key"]),
                val=bytes.fromhex(row["val"]),
                block_number=row["block_number"],
            )
            chain.logs.append(log)
            chain.store[(log.creator, log.about, log.key)] = log.val
        return chain


class ExecutedChain(AttestationStation):
    """AttestationStation backed by the REAL vendored contract bytecode
    running in the in-repo EVM (``client/evm.py``) — the executed twin
    of ``LocalChain``'s modeled semantics.

    Deploy runs the actual creation code (constructor included);
    ``attest`` executes the runtime's calldata decoder, storage writes
    and LOG4 emission; ``get_attestation`` executes the public-mapping
    getter. The reference gets this loop from Anvil + real bytecode
    (``eigentrust/src/lib.rs:695-788``); here the devnet's contract
    registry instantiates THIS class, so a codec or semantic divergence
    between the Python model and the real contract surfaces as a test
    failure (``tests/test_evm_exec.py`` asserts LocalChain equivalence
    tx for tx)."""

    def __init__(self):
        from .att_station_bytecode import creation_bytecode
        from .evm import Evm

        # devnet account: a fixed self address (the EVM only exposes it
        # through ADDRESS, which the contract does not read)
        self.evm = Evm.deploy(creation_bytecode(),
                              caller=b"\x00" * 20,
                              address=b"\xa7" * 20)
        self.logs: list = []
        self.block = 0
        self.gas_used = 0       # tx gas (attest executions)
        self.view_gas_used = 0  # eth_call gas (state discarded)

    def attest(self, creator: bytes, entries: list) -> str:
        return self.attest_raw(creator, abi_encode_attest(entries),
                               entries)

    def attest_raw(self, creator: bytes, calldata: bytes,
                   entries: list | None) -> str:
        """Execute an attest with the CALLER'S raw calldata — the
        devnet path, so the real contract's calldata decoder sees the
        exact wire bytes (not a re-encoding). ``entries`` feeds only
        the tx digest (LocalChain hash parity); pass None when the
        modeled decoder cannot parse what the real contract accepted —
        the digest then covers the raw calldata."""
        from .evm import EvmRevert

        self.block += 1
        try:
            _, gas, logs = self.evm.call(creator, calldata)
        except EvmRevert as e:
            raise EigenError(
                "transaction_error",
                f"attest reverted: {e.data.hex() or e}") from e
        self.gas_used += gas
        for log in logs:
            if log.topics[0] != int(EVENT_TOPIC, 16):
                continue
            # AttestationCreated(indexed creator, indexed about,
            # indexed key, bytes val): val is ABI-encoded in data
            off = int.from_bytes(log.data[:32], "big")
            ln = int.from_bytes(log.data[off:off + 32], "big")
            val = log.data[off + 32:off + 32 + ln]
            self.logs.append(AttestationLog(
                creator=log.topics[1].to_bytes(32, "big")[12:],
                about=log.topics[2].to_bytes(32, "big")[12:],
                key=log.topics[3].to_bytes(32, "big"),
                val=val,
                block_number=self.block,
            ))
        if entries is None:
            digest = keccak256(creator + calldata)
        else:
            digest = keccak256(
                creator + b"".join(a + k + v for a, k, v in entries))
        return "0x" + digest.hex()

    def get_attestation(self, creator: bytes, about: bytes,
                        key: bytes) -> bytes:
        data = (ATTESTATIONS_SELECTOR + _pad32(b"\x00" * 12 + creator)
                + _pad32(b"\x00" * 12 + about) + key)
        return abi_decode_bytes(self.call_raw(data))

    def call_raw(self, calldata: bytes) -> bytes:
        """eth_call against the executed contract: raw calldata in,
        raw ABI return out. eth_call semantics: state changes are
        DISCARDED (storage snapshot/restore), so a mutating simulation
        can never desync the getter from the event log. View gas is
        tracked separately — it is not transaction gas. NOT
        thread-safe against concurrent attests (the snapshot/restore
        writes storage): the devnet serializes through MockNode's
        lock."""
        snapshot = dict(self.evm.storage)
        try:
            ret, gas, _ = self.evm.call(b"\x00" * 20, calldata)
        finally:
            self.evm.storage = snapshot
        self.view_gas_used += gas
        return ret

    def get_logs(self, from_block: int = 0) -> list:
        return [log for log in self.logs
                if log.block_number >= from_block]


# --- minimal ABI coding ---------------------------------------------------


def _pad32(data: bytes) -> bytes:
    return data + b"\x00" * (-len(data) % 32)


def _uint(v: int) -> bytes:
    return v.to_bytes(32, "big")


def abi_encode_attest(entries: list) -> bytes:
    """Calldata for attest((address,bytes32,bytes)[])."""
    # each element tuple is dynamic (contains bytes) → array stores offsets
    elements = []
    for about, key, val in entries:
        # tuple head: about, key, offset-of-val (3 words); tail: len + data
        elem = (
            _pad32(b"\x00" * 12 + about)
            + key
            + _uint(3 * 32)
            + _uint(len(val))
            + _pad32(val)
        )
        elements.append(elem)
    heads = []
    offset = 32 * len(elements)
    for elem in elements:
        heads.append(_uint(offset))
        offset += len(elem)
    array = _uint(len(elements)) + b"".join(heads) + b"".join(elements)
    return ATTEST_SELECTOR + _uint(32) + array


def abi_decode_bytes(data: bytes) -> bytes:
    """Decode a single dynamic `bytes` return/data value."""
    if len(data) < 64:
        raise EigenError("parsing_error", "short ABI bytes payload")
    offset = int.from_bytes(data[:32], "big")
    length = int.from_bytes(data[offset : offset + 32], "big")
    return data[offset + 32 : offset + 32 + length]


class RpcChain(AttestationStation):
    """JSON-RPC AttestationStation client (HTTP, stdlib only)."""

    def __init__(self, node_url: str, contract_address: bytes, chain_id: int = 31337):
        self.node_url = node_url
        self.contract_address = contract_address
        self.chain_id = chain_id
        self._id = 0

    # -- raw rpc -----------------------------------------------------------
    def rpc(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.node_url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                reply = json.loads(resp.read())
        except OSError as e:
            raise EigenError("connection_error", str(e)) from e
        if "error" in reply:
            raise EigenError("network_error", str(reply["error"]))
        return reply["result"]

    # -- AttestationStation surface ---------------------------------------
    def attest_signed(self, keypair, entries: list) -> str:
        """Sign and submit an attest() call from `keypair`."""
        from .eth import address_from_public_key, sign_legacy_tx

        sender = "0x" + address_from_public_key(keypair.public_key).hex()
        nonce = int(self.rpc("eth_getTransactionCount", [sender, "pending"]), 16)
        gas_price = int(self.rpc("eth_gasPrice", []), 16)
        raw = sign_legacy_tx(
            keypair,
            nonce=nonce,
            gas_price=gas_price,
            gas=2_000_000,
            to=self.contract_address,
            value=0,
            data=abi_encode_attest(entries),
            chain_id=self.chain_id,
        )
        return self.rpc("eth_sendRawTransaction", ["0x" + raw.hex()])

    def attest(self, creator: bytes, entries: list) -> str:
        raise EigenError(
            "keys_error",
            "RpcChain needs a signing key; use attest_signed(keypair, entries)",
        )

    @classmethod
    def deploy_signed(cls, node_url: str, keypair, chain_id: int = 31337,
                      gas: int = 2_000_000) -> "RpcChain":
        """Deploy the AttestationStation contract (the vendored creation
        bytecode, ``att_station_bytecode.py``) from ``keypair`` and
        return an RpcChain bound to the created address — the
        reference's ``deploy_as`` (``eigentrust/src/eth.rs:18-25``).

        The created address is derived the EVM way:
        keccak256(rlp([sender, nonce]))[12:]."""
        from .att_station_bytecode import creation_bytecode
        from .eth import address_from_public_key, rlp_encode, sign_legacy_tx

        chain = cls(node_url, b"\x00" * 20, chain_id)
        sender_b = address_from_public_key(keypair.public_key)
        sender = "0x" + sender_b.hex()
        nonce = int(chain.rpc("eth_getTransactionCount",
                              [sender, "pending"]), 16)
        gas_price = int(chain.rpc("eth_gasPrice", []), 16)
        raw = sign_legacy_tx(
            keypair,
            nonce=nonce,
            gas_price=gas_price,
            gas=gas,
            to=b"",  # contract creation
            value=0,
            data=creation_bytecode(),
            chain_id=chain_id,
        )
        txh = chain.rpc("eth_sendRawTransaction", ["0x" + raw.hex()])
        created = keccak256(rlp_encode([sender_b, nonce]))[12:]
        _await_deploy_receipt(chain.rpc, txh, created)
        chain.contract_address = created
        return chain

    def get_attestation(self, creator: bytes, about: bytes, key: bytes) -> bytes:
        data = (ATTESTATIONS_SELECTOR + _pad32(b"\x00" * 12 + creator)
                + _pad32(b"\x00" * 12 + about) + key)
        result = self.rpc(
            "eth_call",
            [{"to": "0x" + self.contract_address.hex(), "data": "0x" + data.hex()}, "latest"],
        )
        return abi_decode_bytes(bytes.fromhex(result.removeprefix("0x")))

    def get_logs(self, from_block: int = 0) -> list:
        raw_logs = self.rpc(
            "eth_getLogs",
            [
                {
                    "fromBlock": hex(from_block),
                    "toBlock": "latest",
                    "address": "0x" + self.contract_address.hex(),
                    "topics": [EVENT_TOPIC],
                }
            ],
        )
        out = []
        for log in raw_logs:
            topics = log["topics"]
            data = bytes.fromhex(log["data"].removeprefix("0x"))
            out.append(
                AttestationLog(
                    creator=bytes.fromhex(topics[1].removeprefix("0x"))[-20:],
                    about=bytes.fromhex(topics[2].removeprefix("0x"))[-20:],
                    key=bytes.fromhex(topics[3].removeprefix("0x")),
                    val=abi_decode_bytes(data),
                    block_number=int(log["blockNumber"], 16),
                )
            )
        return out


class VerifierContract:
    """A deployed generated PLONK verifier, driven over JSON-RPC.

    Twin of the reference's on-chain verifier flow: the Yul artifact
    from ``zk/evm.py`` is deployed as a contract-creation transaction
    and proofs are checked with ``eth_call`` (gas via
    ``eth_estimateGas``) — the devnet executes the code in the in-repo
    EVM (``client/mocknode.py``), so a codegen or calldata-layout bug
    surfaces as an on-chain revert, not a Python library disagreement.
    Reference anchor: eigentrust-zk/src/verifier/mod.rs:148-168 (deploy
    + call against an in-memory EVM)."""

    def __init__(self, node_url: str, address: bytes, chain_id: int = 31337):
        self.node_url = node_url
        self.address = address
        self.chain_id = chain_id
        self._id = 0

    rpc = RpcChain.rpc  # same JSON-RPC plumbing

    @classmethod
    def deploy_signed(cls, node_url: str, keypair, yul_source: str,
                      chain_id: int = 31337, gas: int = 10_000_000,
                      receipt_timeout: float = 120.0) -> "VerifierContract":
        from .eth import address_from_public_key, rlp_encode, sign_legacy_tx

        probe = cls(node_url, b"\x00" * 20, chain_id)
        sender_b = address_from_public_key(keypair.public_key)
        nonce = int(probe.rpc("eth_getTransactionCount",
                              ["0x" + sender_b.hex(), "pending"]), 16)
        gas_price = int(probe.rpc("eth_gasPrice", []), 16)
        raw = sign_legacy_tx(
            keypair, nonce=nonce, gas_price=gas_price, gas=gas,
            to=b"", value=0, data=yul_source.encode("utf-8"),
            chain_id=chain_id,
        )
        txh = probe.rpc("eth_sendRawTransaction", ["0x" + raw.hex()])
        created = keccak256(rlp_encode([sender_b, nonce]))[12:]
        _await_deploy_receipt(probe.rpc, txh, created, receipt_timeout)
        return cls(node_url, created, chain_id)

    def verify(self, calldata: bytes) -> bool:
        """eth_call the verifier; reverts (RPC errors) read as reject."""
        try:
            result = self.rpc("eth_call", [
                {"to": "0x" + self.address.hex(),
                 "data": "0x" + calldata.hex()}, "latest"])
        except EigenError:
            return False
        out = bytes.fromhex(result.removeprefix("0x"))
        return len(out) == 32 and int.from_bytes(out, "big") == 1

    def estimate_gas(self, calldata: bytes) -> int:
        return int(self.rpc("eth_estimateGas", [
            {"to": "0x" + self.address.hex(),
             "data": "0x" + calldata.hex()}]), 16)
