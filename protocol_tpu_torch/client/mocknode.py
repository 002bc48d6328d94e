"""In-repo mock JSON-RPC devnet for the AttestationStation flow.

The reference integration-tests its client against a real Anvil devnet
spawned per test (``eigentrust/src/lib.rs:695-788``). This environment
has no EVM node, so this module provides the devnet stand-in the
VERDICT asked for: a threaded stdlib HTTP server speaking enough of the
Ethereum JSON-RPC surface for the full deploy → attest → logs → scores
round trip:

- ``eth_chainId`` / ``eth_blockNumber`` / ``eth_gasPrice`` /
  ``eth_getTransactionCount`` / ``eth_getTransactionReceipt``
- ``eth_sendRawTransaction``: decodes the EIP-155 legacy RLP
  transaction, RECOVERS THE SENDER from the signature (the part a
  codec-level test can't exercise), and executes it: contract-creation
  transactions register an AttestationStation instance at the EVM
  create address; calls to a registered instance decode the
  ``attest((address,bytes32,bytes)[])`` calldata and append logs.
- ``eth_getLogs`` / ``eth_call`` (the ``attestations`` getter).

Both contract families EXECUTE real code (r5; previously the station
was modeled):

- a creation transaction carrying the vendored AttestationStation
  creation bytecode deploys through the in-repo EVM **bytecode**
  interpreter (``client/evm.py``): the constructor runs, attest txs
  run the real calldata decoder/storage writes/LOG4 emission on the
  wire bytes, and ``eth_call`` executes the real public-mapping
  getter — the loop the reference gets from Anvil + real bytecode
  (``eigentrust/src/lib.rs:695-788``). Equivalence with the modeled
  ``LocalChain`` semantics is asserted in ``tests/test_evm_exec.py``;
  any OTHER non-Yul creation data still registers a modeled
  ``LocalChain`` (documented fallback for protocol-level tests).
- a creation transaction whose data is Yul source (the
  ``object "PlonkVerifier"`` artifact from ``zk/evm.py``) registers a
  contract whose ``eth_call``/``eth_estimateGas`` run the code through
  the in-repo Yul EVM (``zk/yul.py``, yellow-paper gas schedule) — the
  proof artifact is verified *on-chain over JSON-RPC*, not by a
  library call (``eigentrust-zk/src/verifier/mod.rs:148-168``).

The port's copy of ``protocol_tpu/client/mocknode.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto.secp256k1 import Signature, recover_public_key
from ..utils.keccak import keccak256
from .att_station_bytecode import creation_bytecode
from .chain import (
    ATTEST_SELECTOR,
    ATTESTATIONS_SELECTOR,
    EVENT_TOPIC,
    ExecutedChain,
    LocalChain,
)
from .eth import address_from_public_key, rlp_encode

YUL_CREATION_MARKER = b'object "PlonkVerifier"'


class YulContract:
    """A deployed generated verifier: calls execute in the in-repo EVM."""

    def __init__(self, source: str):
        self.source = source

    def call(self, calldata: bytes) -> bytes:
        from ..zk.yul import YulVM  # VMRevert propagates to the RPC error

        out, _gas = YulVM(self.source).run(calldata)
        return out

    def estimate_gas(self, calldata: bytes) -> int:
        from ..zk.yul import YulVM

        _out, gas = YulVM(self.source).run_tx(calldata)
        return gas


def _rlp_decode(data: bytes):
    """Minimal RLP decoder (bytes + lists), returns (item, rest)."""
    if not data:
        raise ValueError("empty rlp")
    b0 = data[0]
    if b0 < 0x80:
        return data[:1], data[1:]
    if b0 < 0xB8:
        ln = b0 - 0x80
        return data[1 : 1 + ln], data[1 + ln :]
    if b0 < 0xC0:
        lln = b0 - 0xB7
        ln = int.from_bytes(data[1 : 1 + lln], "big")
        return data[1 + lln : 1 + lln + ln], data[1 + lln + ln :]
    if b0 < 0xF8:
        ln = b0 - 0xC0
        payload = data[1 : 1 + ln]
        rest = data[1 + ln :]
    else:
        lln = b0 - 0xF7
        ln = int.from_bytes(data[1 : 1 + lln], "big")
        payload = data[1 + lln : 1 + lln + ln]
        rest = data[1 + lln + ln :]
    items = []
    while payload:
        item, payload = _rlp_decode(payload)
        items.append(item)
    return items, rest


def _decode_attest_calldata(data: bytes) -> list:
    """Inverse of ``abi_encode_attest``: [(about, key, val)]."""
    assert data[:4] == ATTEST_SELECTOR
    body = data[4:]
    array_off = int.from_bytes(body[:32], "big")
    arr = body[array_off:]
    count = int.from_bytes(arr[:32], "big")
    entries = []
    for i in range(count):
        off = int.from_bytes(arr[32 + 32 * i : 64 + 32 * i], "big")
        elem = arr[32 + off :]
        about = elem[12:32]
        key = elem[32:64]
        val_off = int.from_bytes(elem[64:96], "big")  # rel. tuple start
        val_len = int.from_bytes(elem[val_off : val_off + 32], "big")
        val = elem[val_off + 32 : val_off + 32 + val_len]
        entries.append((about, key, val))
    return entries


class MockNode:
    """Threaded mock devnet; start() returns the node URL."""

    def __init__(self, chain_id: int = 31337):
        self.chain_id = chain_id
        self.nonces: dict = {}
        self.contracts: dict = {}   # address bytes -> LocalChain
        self.receipts: dict = {}
        self.block = 0
        self._lock = threading.Lock()
        self._server = None
        self._thread = None

    # -- tx execution ------------------------------------------------------
    def _execute_raw_tx(self, raw: bytes) -> str:
        fields, rest = _rlp_decode(raw)
        if rest:
            raise ValueError("trailing tx bytes")
        nonce, gas_price, gas, to, value, data, v, r, s = fields
        nonce_i = int.from_bytes(nonce, "big")
        v_i = int.from_bytes(v, "big")
        rec_id = (v_i - 35 - self.chain_id * 2)
        if rec_id not in (0, 1):
            raise ValueError("bad EIP-155 v")
        sighash = keccak256(rlp_encode(
            [nonce, gas_price, gas, to, value, data, self.chain_id, 0, 0]))
        sig = Signature(int.from_bytes(r, "big"), int.from_bytes(s, "big"),
                        rec_id)
        sender_pk = recover_public_key(sig, int.from_bytes(sighash, "big"))
        sender = address_from_public_key(sender_pk)
        with self._lock:
            expected = self.nonces.get(sender, 0)
            if nonce_i != expected:
                raise ValueError(f"bad nonce {nonce_i}, expected {expected}")
            self.nonces[sender] = expected + 1
            self.block += 1
            txh = keccak256(raw)
            if len(to) == 0:
                # contract creation at keccak(rlp([sender, nonce]))[12:];
                # Yul-source data deploys an executed verifier contract,
                # anything else the modeled AttestationStation
                addr = keccak256(rlp_encode([sender, nonce_i]))[12:]
                if YUL_CREATION_MARKER in bytes(data):
                    self.contracts[addr] = YulContract(
                        bytes(data).decode("utf-8"))
                elif bytes(data) == creation_bytecode():
                    # the real artifact: run its constructor in the
                    # bytecode EVM and serve the executed contract
                    self.contracts[addr] = ExecutedChain()
                else:
                    self.contracts[addr] = LocalChain()
                self.receipts[txh] = {"contractAddress": "0x" + addr.hex(),
                                      "status": "0x1",
                                      "blockNumber": hex(self.block)}
            else:
                chain = self.contracts.get(bytes(to))
                if chain is None:
                    raise ValueError("no contract at target address")
                if isinstance(chain, YulContract):
                    raise ValueError(
                        "verifier contract is view-only; use eth_call")
                if isinstance(chain, ExecutedChain):
                    # executed station: the REAL solc decoder is
                    # authoritative on the wire calldata; the modeled
                    # decoder runs only afterwards for the tx digest
                    # (None if it cannot parse what the contract took)
                    try:
                        entries = _decode_attest_calldata(bytes(data))
                    except Exception:
                        entries = None
                    chain.attest_raw(sender, bytes(data), entries)
                else:
                    entries = _decode_attest_calldata(bytes(data))
                    chain.attest(sender, entries)
                self.receipts[txh] = {"contractAddress": None,
                                      "status": "0x1",
                                      "blockNumber": hex(self.block)}
            return "0x" + txh.hex()

    # -- rpc dispatch ------------------------------------------------------
    def handle(self, method: str, params: list):
        if method == "eth_chainId":
            return hex(self.chain_id)
        if method == "eth_blockNumber":
            return hex(self.block)
        if method == "eth_gasPrice":
            return hex(10**9)
        if method == "eth_getTransactionCount":
            addr = bytes.fromhex(params[0].removeprefix("0x"))
            return hex(self.nonces.get(addr, 0))
        if method == "eth_getTransactionReceipt":
            return self.receipts.get(
                bytes.fromhex(params[0].removeprefix("0x")))
        if method == "eth_sendRawTransaction":
            return self._execute_raw_tx(
                bytes.fromhex(params[0].removeprefix("0x")))
        if method == "eth_getLogs":
            q = params[0]
            addr = bytes.fromhex(q["address"].removeprefix("0x"))
            chain = self.contracts.get(addr)
            if chain is None:
                return []
            from_block = int(q.get("fromBlock", "0x0"), 16)
            out = []
            for log in chain.get_logs():
                if log.block_number < from_block:
                    continue
                out.append({
                    "address": q["address"],
                    "topics": [
                        EVENT_TOPIC,
                        "0x" + log.creator.rjust(32, b"\x00").hex(),
                        "0x" + log.about.rjust(32, b"\x00").hex(),
                        "0x" + log.key.hex(),
                    ],
                    "data": "0x" + (
                        (32).to_bytes(32, "big")
                        + len(log.val).to_bytes(32, "big")
                        + log.val + b"\x00" * (-len(log.val) % 32)
                    ).hex(),
                    "blockNumber": hex(log.block_number),
                })
            return out
        if method == "eth_call":
            call = params[0]
            addr = bytes.fromhex(call["to"].removeprefix("0x"))
            chain = self.contracts.get(addr)
            if chain is None:
                return "0x"
            data = bytes.fromhex(call["data"].removeprefix("0x"))
            if isinstance(chain, YulContract):
                from ..zk.yul import VMRevert

                try:
                    return "0x" + chain.call(data).hex()
                except VMRevert as e:
                    raise ValueError(f"execution reverted: {e}") from e
            if isinstance(chain, ExecutedChain):
                from .evm import EvmRevert

                # the snapshot/restore in call_raw writes storage:
                # serialize against concurrent attest txs
                with self._lock:
                    try:
                        return "0x" + chain.call_raw(data).hex()
                    except EvmRevert as e:
                        raise ValueError(
                            f"execution reverted: {e}") from e
            if data[:4] != ATTESTATIONS_SELECTOR:
                raise ValueError("unsupported call selector")
            creator = data[16:36]
            about = data[48:68]
            key = data[68:100]
            val = chain.get_attestation(creator, about, key)
            enc = ((32).to_bytes(32, "big")
                   + len(val).to_bytes(32, "big")
                   + val + b"\x00" * (-len(val) % 32))
            return "0x" + enc.hex()
        if method == "eth_estimateGas":
            call = params[0]
            addr = bytes.fromhex(call["to"].removeprefix("0x"))
            chain = self.contracts.get(addr)
            data = bytes.fromhex(call.get("data", "0x").removeprefix("0x"))
            if isinstance(chain, YulContract):
                from ..zk.yul import VMRevert

                try:
                    return hex(chain.estimate_gas(data))
                except VMRevert as e:
                    raise ValueError(f"execution reverted: {e}") from e
            return hex(100_000)
        raise ValueError(f"unsupported method {method}")

    # -- http --------------------------------------------------------------
    def start(self) -> str:
        node = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                try:
                    result = node.handle(req["method"], req.get("params", []))
                    reply = {"jsonrpc": "2.0", "id": req.get("id"),
                             "result": result}
                except Exception as e:  # noqa: BLE001 - devnet surface
                    reply = {"jsonrpc": "2.0", "id": req.get("id"),
                             "error": {"code": -32000, "message": str(e)}}
                body = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        # a short poll: stop() returns within 50 ms, not the default 0.5 s
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        name="mocknode-http", daemon=True)
        self._thread.start()
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
