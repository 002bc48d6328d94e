"""Stable facade over the proving stack for the CLI / Client layers.

Byte-level artifacts in, byte-level artifacts out — the CLI persists them
via the EigenFile layout exactly like the reference persists halo2's
serialized params/keys/proofs (eigentrust-cli/src/fs.rs:50-84).

The port of ``protocol_tpu/zk/api.py``: twin of the reference Client's
proving surface (eigentrust/src/lib.rs): ``generate_kzg_params``
:588-604, ``generate_et_pk`` :537-558 (dummy circuit for key shape),
``generate_et_proof`` :239-269, ``verify`` :304-336, ``generate_th_pk``
:561-585 (which, like the reference, must prove a full EigenTrust snark
first to derive the Threshold key), ``generate_th_proof`` :272-301
(re-proves the ET circuit with the Poseidon transcript and aggregates it
in-circuit — the reference's ``Snark::new`` + ``NativeAggregator``
path, aggregator/native.rs:75-187) and the Yul/EVM verifier
(``gen_et_evm_verifier``, ``et_evm_calldata``; verifier/mod.rs:116-145).
The artifacts are the reference package's, byte for byte: a key or
proof written by either package verifies under the other.

Every prove goes through ``prover_fast.prove_auto``: rounds 3–4 on the
card (``device``, default the card; it raises without one unless given
the CPU, where the host prover runs) and rounds 1–2 and every
commitment on the host's C++ prover core. A device prove that fails
raises; it never falls back to the host. The Threshold flow's two
proves (the inner EigenTrust snark and the outer Threshold circuit) both
run on the one device its caller names.

One deliberate divergence from the reference, kept from the reference
package: the reference ships two independent SRS files (k=20 and k=21).
KZG accumulation is only sound when the aggregated snark and the decider
share one τ, and this stack generates params freshly (no shared
ceremony), so the Threshold flow proves the inner EigenTrust snark under
the *Threshold* SRS.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass
from fractions import Fraction

from ..utils import trace
from ..utils.errors import EigenError
from ..utils.fields import Fr


@dataclass(frozen=True)
class CircuitShape:
    """The EigenTrust4 instantiation (circuits/mod.rs:38-59) as runtime
    config — const generics in the reference, shape params here."""

    num_neighbours: int = 4
    num_iterations: int = 20
    initial_score: int = 1000
    lookup_bits: int = 17
    num_limbs: int = 2
    power_of_ten: int = 72


DEFAULT_SHAPE = CircuitShape()

# the 2-peer / 2-iteration dev instantiation: ECDSA chips dominate rows,
# so this is the smallest REAL shape (790k rows -> k=20). Single source
# of truth for the CLI --shape tiny flag, the measurement tools and the
# test suite.
TINY_SHAPE = CircuitShape(num_neighbours=2, num_iterations=2,
                          lookup_bits=12)

_DUMMY_SEED = 0xD00D


def generate_kzg_params(k: int, seed: bytes | None = None) -> bytes:
    """Universal SRS for circuits up to 2^k rows (lib.rs:588-604)."""
    from .prover_fast import available, setup_params_fast

    if available():
        return setup_params_fast(k, seed=seed).to_bytes()
    from .kzg import KZGParams

    return KZGParams.setup(k, seed=seed).to_bytes()


def _keygen(params, cs):
    from .prover_fast import available, keygen_fast

    if available():
        # "auto": eval-form key (no keygen iNTTs, 8× faster at k=20)
        # whenever the params carry a matching Lagrange basis. When the
        # circuit's natural domain is SMALLER than the SRS (the
        # Threshold flow proves its inner EigenTrust snark under the
        # shared k=21 SRS), snap k up to the SRS domain: a padded
        # eval-form key + the device prover beat a tight-domain
        # coefficient-form key by minutes per proof.
        k = None
        if params.g1_lagrange is not None:
            from .prover_fast import natural_k

            needed = natural_k(cs)
            if needed <= params.k <= needed + 1:
                # at most one domain doubling of padding — beyond that
                # the tight-domain coefficient-form key wins again
                k = params.k
        return keygen_fast(params, cs, k=k, eval_pk="auto")
    from .plonk import keygen

    return keygen(params, cs)


def _prove(params, pk, cs, transcript: str = "poseidon", device=None):
    from .prover_fast import FastProvingKey, prove_auto

    _join_prewarm()
    if isinstance(pk, FastProvingKey):
        # device round-3/4 when a card + eval-form key are available; a
        # device fault raises (no host fallback)
        return prove_auto(params, pk, cs, transcript=transcript,
                          device=device)
    from .plonk import prove

    return prove(params, pk, cs, transcript=transcript)


def _load_params(params: bytes):
    from .kzg import KZGParams

    return KZGParams.from_bytes(params)


_PK_PARSE_CACHE: list = []  # MRU-first [(pk bytes object, parsed key)]
_PK_PARSE_LOCK = threading.Lock()  # the proof pool's workers call
# _load_pk concurrently (shared ArtifactCache bytes, N provers); an
# unlocked scan/insert/trim would double-parse ~0.5 GB keys and leave
# duplicate entries whose MRU churn breaks the identity keys the
# per-worker DeviceProver caches rely on


def _load_pk(pk: bytes):
    """Format-sniffing load: FPK1/FPK2 limb-array keys (native kernels) or
    the pure-Python ProvingKey JSON — each proves via its own path in
    ``_prove``.

    Parsed keys are cached per bytes OBJECT (identity compare, strong
    refs, 2 entries): ``generate_th_proof`` passes the same ~0.5 GB key
    bytes every call, and without the cache each call re-parses the key
    AND breaks the identity key of the DeviceProver cache behind it —
    re-paying the full device init per proof. Callers that re-read the
    bytes from disk simply miss and parse, exactly as before. The lock
    makes a concurrent same-pk miss parse ONCE (pool workers share the
    pk bytes; the parse is host work safely serialized — seconds, once
    per process per key)."""
    with _PK_PARSE_LOCK:
        for i, entry in enumerate(_PK_PARSE_CACHE):
            if entry[0] is pk:
                if i:
                    _PK_PARSE_CACHE.insert(0, _PK_PARSE_CACHE.pop(i))
                return entry[1]
        from .prover_fast import FastProvingKey, _dp_cache_cap

        if pk[:4] in (b"FPK1", b"FPK2"):
            obj = FastProvingKey.from_bytes(pk)
        else:
            from .plonk import ProvingKey

            obj = ProvingKey.from_bytes(pk)
        _PK_PARSE_CACHE.insert(0, (pk, obj))
        # cap follows the DeviceProver cache: a smaller parse cache
        # would silently defeat a raised PTPU_DP_CACHE (identity keys
        # downstream)
        del _PK_PARSE_CACHE[_dp_cache_cap():]
        return obj


def _load_vk(pk: bytes):
    from .prover_fast import VerifyingKey

    return VerifyingKey.from_key_bytes(pk)


def _load_params_verifier(params: bytes):
    """Header + τG2 only — verification never touches the G1 powers,
    and at k=22 the full SRS is ~270 MB."""
    from .kzg import KZGParams

    try:
        return KZGParams.verifier_from_bytes(params)
    except ValueError as e:
        raise EigenError("parsing_error", str(e)) from e


def _dummy_et_fixture(shape: CircuitShape):
    """Deterministic full-opinion fixture giving the canonical circuit
    shape — the reference's dummy-circuit trick for keygen
    (lib.rs:537-558; with its NUM_ITERATIONS/NUM_NEIGHBOURS dim quirk
    deliberately not replicated, SURVEY.md §7.3)."""
    from ..crypto.secp256k1 import EcdsaKeypair
    from ..models.eigentrust import Attestation, EigenTrustSet, SignedAttestation
    from .eigentrust_circuit import ETWitness

    n = shape.num_neighbours
    kps = [EcdsaKeypair(_DUMMY_SEED + i) for i in range(n)]
    addrs = [kp.public_key.to_address() for kp in kps]
    domain = Fr(1)
    native = EigenTrustSet(n, shape.num_iterations, shape.initial_score, domain)
    for a in addrs:
        native.add_member(a)
    matrix = [[None] * n for _ in range(n)]
    for i in range(n):
        signed = []
        for j in range(n):
            if i == j:
                signed.append(None)
                continue
            att = Attestation(about=addrs[j], domain=domain,
                              value=Fr(100), message=Fr.zero())
            sa = SignedAttestation(att, kps[i].sign(int(att.hash())))
            signed.append(sa)
            matrix[i][j] = sa
        native.update_op(kps[i].public_key, signed)
    scores = native.converge()
    ratios = native.converge_rational()
    witness = ETWitness(addresses=list(addrs),
                        pubkeys=[kp.public_key for kp in kps],
                        att_matrix=matrix, domain=domain)
    return witness, addrs, scores, ratios


def _build_et_circuit(witness, shape: CircuitShape):
    from .eigentrust_circuit import EigenTrustSetCircuit

    circuit = EigenTrustSetCircuit(
        num_neighbours=shape.num_neighbours,
        num_iterations=shape.num_iterations,
        initial_score=shape.initial_score,
        lookup_bits=shape.lookup_bits,
    )
    return circuit.build(witness)


def demo_et_setup(shape: CircuitShape = TINY_SHAPE, seed: int = 5000):
    """A deterministic REAL ETSetup built directly (no chain): sparse
    opinions over ``shape.num_neighbours`` peers — the fixture behind
    the measurement tools and the test suite's tiny cycles. Unlike
    ``_dummy_et_fixture`` (full opinions, keygen shape only) this
    produces a structurally sparse witness."""
    from ..client.circuit_io import ETPublicInputs, ETSetup
    from ..crypto.poseidon import PoseidonSponge
    from ..crypto.secp256k1 import EcdsaKeypair
    from ..models.eigentrust import (
        HASHER_WIDTH,
        Attestation,
        EigenTrustSet,
        SignedAttestation,
    )

    domain = Fr(42)
    n = shape.num_neighbours
    kps = [EcdsaKeypair(seed + i) for i in range(n)]
    addrs = [kp.public_key.to_address() for kp in kps]
    native = EigenTrustSet(n, shape.num_iterations, shape.initial_score,
                           domain)
    for a in addrs:
        native.add_member(a)
    matrix = [[None] * n for _ in range(n)]
    op_hashes = []
    # ring of sparse opinions: peer i attests only peer (i+1) mod n
    rows = {i: {(i + 1) % n: 400 + 200 * i} for i in range(n)}
    for i, row in rows.items():
        signed = []
        for j in range(n):
            if row.get(j):
                att = Attestation(about=addrs[j], domain=domain,
                                  value=Fr(row[j]), message=Fr.zero())
                sa = SignedAttestation(att, kps[i].sign(int(att.hash())))
                signed.append(sa)
                matrix[i][j] = sa
            else:
                signed.append(None)
        op_hashes.append(native.update_op(kps[i].public_key, signed))
    scores = native.converge()
    ratios = native.converge_rational()
    sponge = PoseidonSponge(HASHER_WIDTH)
    sponge.update(op_hashes)
    pub_inputs = ETPublicInputs(list(addrs), scores, domain,
                                sponge.squeeze())
    return ETSetup(
        address_set=[a.to_bytes_be()[12:] for a in addrs],
        attestation_matrix=matrix,
        pub_keys=[kp.public_key for kp in kps],
        pub_inputs=pub_inputs,
        rational_scores=ratios,
    )


def generate_et_pk(params: bytes, shape: CircuitShape = DEFAULT_SHAPE) -> bytes:
    """Proving key over the dummy-witness circuit (lib.rs:537-558); the
    circuit structure is witness-independent, so the key proves any
    same-shape witness."""
    p = _load_params(params)
    witness, *_ = _dummy_et_fixture(shape)
    chips, _ = _build_et_circuit(witness, shape)
    return _keygen(p, chips.cs).to_bytes()


def _et_setup_circuit(setup, shape: CircuitShape):
    """Rebuild the satisfied circuit from an ETSetup and cross-check its
    public inputs against the setup's (lib.rs:239-269 builds EigenTrust4
    from the same matrix it converged natively)."""
    from .eigentrust_circuit import ETWitness

    witness = ETWitness(
        addresses=list(setup.pub_inputs.participants),
        pubkeys=list(setup.pub_keys),
        att_matrix=setup.attestation_matrix,
        domain=setup.pub_inputs.domain,
    )
    chips, pubs = _build_et_circuit(witness, shape)
    expected = [int(x) for x in setup.pub_inputs.to_flat()]
    if pubs != expected:
        raise EigenError(
            "proving_error",
            "circuit public inputs diverge from the native setup",
        )
    return chips, pubs


def generate_et_proof(params: bytes, pk: bytes, setup,
                      shape: CircuitShape = DEFAULT_SHAPE,
                      transcript: str = "poseidon", device=None) -> bytes:
    """``transcript="keccak"`` emits the on-chain-cheap proof (one
    keccak256 per Fiat–Shamir challenge); "poseidon" keeps recursion
    parity with the in-circuit aggregator. ``device`` is the torch
    device of rounds 3–4: None means the card (and raises without one,
    before any work); a CPU device proves on the host."""
    from ..device import resolve_device

    device = resolve_device(device)
    p = _load_params(params)
    chips, _ = _et_setup_circuit(setup, shape)
    return _prove(p, _load_pk(pk), chips.cs, transcript=transcript,
                  device=device)


def verify_et(params: bytes, pk: bytes, pub_inputs: bytes, proof: bytes,
              shape: CircuitShape = DEFAULT_SHAPE,
              transcript: str = "poseidon") -> bool:
    from ..client.circuit_io import ETPublicInputs
    from .plonk import verify

    p = _load_params_verifier(params)
    pubs = ETPublicInputs.from_bytes(pub_inputs, shape.num_neighbours)
    flat = [int(x) for x in pubs.to_flat()]
    return verify(p, _load_vk(pk), flat, proof, transcript=transcript)


def gen_et_evm_verifier(params: bytes, pk: bytes,
                        transcript: str = "keccak") -> str:
    """Yul source of the EVM verifier for the EigenTrust circuit —
    the reference's deployable artifact (verifier/mod.rs:116-145).
    Pairs with proofs from ``generate_et_proof(transcript=...)``."""
    from .evm import gen_evm_verifier_code

    return gen_evm_verifier_code(_load_params_verifier(params),
                                 _load_vk(pk), transcript=transcript)


def et_evm_calldata(pub_inputs: bytes, proof: bytes,
                    shape: CircuitShape = DEFAULT_SHAPE) -> bytes:
    """ABI calldata (instances ‖ proof) for the generated verifier."""
    from ..client.circuit_io import ETPublicInputs
    from .evm import encode_calldata

    pubs = ETPublicInputs.from_bytes(pub_inputs, shape.num_neighbours)
    return encode_calldata([int(x) for x in pubs.to_flat()], proof)


# --- inner-ET artifact caches ----------------------------------------------
# The Threshold flow builds the SAME inner EigenTrust circuit structure
# twice: generate_th_pk proves a dummy-witness snark to derive the
# aggregated circuit shape (the reference's th_circuit_setup quirk,
# lib.rs:561-585), and generate_th_proof proves the real witness. The
# ET proving key depends only on (SRS, circuit structure) — one keygen
# serves both phases — and the dummy snark is a deterministic fixture,
# reusable across runs for a given SRS. SURVEY §7.3 licenses beating
# the reference's re-keygen-and-re-prove-everything behavior; soundness
# is unaffected (the dummy snark only fixes the keygen circuit shape,
# and disk-cached proofs are re-verified before use).

_INNER_ET_PK_CACHE: dict = {}  # (params_sha256, shape) -> proving key obj


def _params_digest(params: bytes) -> bytes:
    return hashlib.sha256(params).digest()


def _inner_et_keygen(p, cs, cache_key):
    pk = _INNER_ET_PK_CACHE.get(cache_key)
    if pk is None:
        pk = _keygen(p, cs)
        _INNER_ET_PK_CACHE.clear()  # ~1 GB at k=21; keep one
        _INNER_ET_PK_CACHE[cache_key] = pk
    return pk


_PREWARM_THREADS: list = []


def _prewarm_device_prover(pk_obj, device=None) -> None:
    """Best-effort: build (or resume) ``pk_obj``'s DeviceProver on a
    daemon thread, overlapping its device init (pk uploads + iNTTs +
    resident ext-table builds) with the caller's GIL-releasing host
    work. ``generate_th_pk``'s warm path starts this before the outer
    Threshold keygen (a native MSM pass), so the inner ET prover that
    ``generate_th_proof`` needs next is warm by the time it proves.

    The prover is warmed in the CALLER's DeviceProver cache (a pool
    worker's own, else the process-wide one) on ``device``, the device
    the next prove uses; a CPU device, or no card, warms nothing.
    ``_prove`` joins any live prewarm before dispatching — the device
    is never driven concurrently with a prove. A prewarm that fails
    leaves the prove to init on demand, where a failure raises."""
    _join_prewarm()
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return
    if not getattr(pk_obj, "eval_form", False) or pk_obj.k > 21:
        return  # prove_auto would not take the device path anyway
    from .prover_fast import current_dp_cache

    cache = current_dp_cache()

    def _run():
        try:
            with trace.span("th.inner_dp_prewarm"):
                cache.get(pk_obj, device)
        except Exception:
            pass  # best effort — the prove path inits on demand

    t = threading.Thread(target=_run, daemon=True, name="ptpu-dp-prewarm")
    t.start()
    _PREWARM_THREADS.append(t)


def _join_prewarm() -> None:
    # pop-with-catch: concurrent pool workers can race the emptiness
    # check, and a lost race must be a no-op, not an IndexError
    while True:
        try:
            t = _PREWARM_THREADS.pop()
        except IndexError:
            return
        t.join()


def _th_cache_dir() -> str | None:
    """PTPU_TH_CACHE_DIR opts into persisting the dummy inner-ET snark
    (pk + proof + public inputs) across processes — the CLI and the
    measured cycle set it; default is in-memory caching only."""
    return os.environ.get("PTPU_TH_CACHE_DIR") or None


def _dummy_snark_path(digest: bytes, shape: CircuitShape) -> str | None:
    d = _th_cache_dir()
    if d is None:
        return None
    tag = hashlib.sha256(
        digest + repr(shape).encode()).hexdigest()[:16]
    return os.path.join(d, f"th_inner_dummy_{tag}.bin")


def _load_dummy_snark(params: bytes, digest, shape: CircuitShape,
                      expect=None):
    """(et_pk_obj, et_pubs, et_proof) from the disk cache, or None.
    The cached proof is re-verified under these params before use —
    a stale or corrupt cache falls through to the fresh path.

    ``expect=(addrs, scores, domain)`` (the fixture ``generate_th_pk``
    computes anyway) cross-checks the cache against the circuit it is
    supposed to encode: the verify alone is self-referential (proof vs a vk
    parsed from the SAME cached bytes), so a tampered-but-consistent
    file would silently swap the inner circuit the Threshold pk is
    keygen'd for and only surface later as an opaque prove failure.
    The ET public-input layout is participants ‖ scores ‖ domain ‖
    op-hash (eigentrust_circuit.py build), so the prefix is natively
    recomputable without a circuit build."""
    path = _dummy_snark_path(digest, shape)
    if path is None or not os.path.exists(path):
        return None
    try:
        import json

        with open(path, "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen).decode())
            pk_bytes = f.read(header["pk_len"])
            proof = f.read(header["proof_len"])
        pubs = [int(v) for v in header["pubs"]]
        from .plonk import verify

        vk = _load_vk(pk_bytes)
        if not verify(_load_params_verifier(params), vk, pubs, proof):
            return None
        if expect is not None:
            addrs, scores, domain = expect
            n = shape.num_neighbours
            ok = (len(pubs) == 2 * n + 2
                  and pubs[:n] == [int(a) for a in addrs]
                  and pubs[n:2 * n] == [int(s) for s in scores]
                  and pubs[2 * n] == int(domain)
                  and vk.lookup_bits == shape.lookup_bits
                  and len(vk.public_rows) == len(pubs))
            if not ok:
                return None
        return _load_pk(pk_bytes), pubs, proof
    except Exception:
        return None


def _store_dummy_snark(digest, shape: CircuitShape, et_pk, pubs,
                       proof: bytes) -> None:
    path = _dummy_snark_path(digest, shape)
    if path is None:
        return
    try:
        import json

        os.makedirs(os.path.dirname(path), exist_ok=True)
        pk_bytes = et_pk.to_bytes()
        header = json.dumps({"pk_len": len(pk_bytes),
                             "proof_len": len(proof),
                             "pubs": [str(v) for v in pubs]}).encode()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(len(header).to_bytes(8, "little"))
            f.write(header)
            f.write(pk_bytes)
            f.write(proof)
        os.replace(tmp, path)
    except OSError:
        pass


def _build_th_circuit(et_pk, et_pubs, et_proof, target_address: Fr,
                      threshold: Fr, ratio: Fraction, shape: CircuitShape):
    from .threshold_circuit import ThresholdCircuit

    circuit = ThresholdCircuit(
        num_neighbours=shape.num_neighbours,
        num_limbs=shape.num_limbs,
        power_of_ten=shape.power_of_ten,
        initial_score=shape.initial_score,
        lookup_bits=shape.lookup_bits,
    )
    return circuit.build_aggregated(et_pk, et_pubs, et_proof,
                                    target_address, threshold, ratio)


def _aggregate_th_circuit(p, et_chips, et_pubs, target_address: Fr,
                          threshold: Fr, ratio: Fraction,
                          shape: CircuitShape, cache_key=None, device=None):
    """ET snark (keygen + prove under the shared SRS) aggregated inside
    the Threshold circuit — the reference's th_circuit_setup hot path
    (lib.rs:469-534: Snark::new re-keygens and re-proves the whole ET
    circuit, aggregator/native.rs:78-96). The keygen half is served
    from ``_INNER_ET_PK_CACHE`` when the same (SRS, shape) was keyed
    before. The inner prove runs on ``device``."""
    with trace.span("th.inner_et_keygen"):
        if cache_key is not None:
            et_pk = _inner_et_keygen(p, et_chips.cs, cache_key)
        else:
            et_pk = _keygen(p, et_chips.cs)
    with trace.span("th.inner_et_prove"):
        et_proof = _prove(p, et_pk, et_chips.cs, device=device)
    with trace.span("th.build_th_circuit"):
        return _build_th_circuit(et_pk, et_pubs, et_proof, target_address,
                                 threshold, ratio, shape)


def generate_th_pk(params: bytes, shape: CircuitShape = DEFAULT_SHAPE,
                   device=None) -> bytes:
    """Threshold proving key. Like the reference (lib.rs:561-585) this
    must build the full aggregated circuit — i.e. prove a dummy
    EigenTrust snark first — to derive the key. Unlike the reference,
    the dummy snark (a deterministic fixture) is cached per (SRS,
    shape): with PTPU_TH_CACHE_DIR set, a warm th-pk pays only the
    Threshold keygen itself, and the inner ET proving key is shared
    with the later ``generate_th_proof`` in-process. ``device`` is the
    torch device of the dummy snark's rounds 3–4 (None: the card, and
    raises without one before any work; a CPU device proves on the
    host)."""
    from ..device import resolve_device

    device = resolve_device(device)
    p = _load_params(params)
    digest = _params_digest(params)
    cache_key = (digest, shape)
    witness, addrs, scores, ratios = _dummy_et_fixture(shape)
    cached = _load_dummy_snark(params, digest, shape,
                               expect=(addrs, scores, witness.domain))
    if cached is not None:
        et_pk, et_pubs, et_proof = cached
        _INNER_ET_PK_CACHE.clear()
        _INNER_ET_PK_CACHE[cache_key] = et_pk
        # warm the inner prover's device state under the outer keygen:
        # the cached-snark path never proves in this phase, so without
        # this the inner ET prove in generate_th_proof pays the full
        # device init serially
        _prewarm_device_prover(et_pk, device)
        with trace.span("th.build_th_circuit"):
            chips, _ = _build_th_circuit(et_pk, et_pubs, et_proof, addrs[0],
                                         Fr(1), ratios[0], shape)
        with trace.span("th.outer_keygen"):
            return _keygen(p, chips.cs).to_bytes()
    with trace.span("th.et_setup_circuit"):
        et_chips, et_pubs = _build_et_circuit(witness, shape)
    with trace.span("th.inner_et_keygen"):
        et_pk = _inner_et_keygen(p, et_chips.cs, cache_key)
    with trace.span("th.inner_et_prove"):
        et_proof = _prove(p, et_pk, et_chips.cs, device=device)
    _store_dummy_snark(digest, shape, et_pk, et_pubs, et_proof)
    with trace.span("th.build_th_circuit"):
        chips, _ = _build_th_circuit(et_pk, et_pubs, et_proof, addrs[0],
                                     Fr(1), ratios[0], shape)
    with trace.span("th.outer_keygen"):
        return _keygen(p, chips.cs).to_bytes()


def generate_th_proof(params: bytes, pk: bytes, setup,
                      shape: CircuitShape = DEFAULT_SHAPE,
                      device=None) -> bytes:
    """Prove the Threshold circuit for a ThSetup. Fills in
    ``setup.pub_inputs.agg_instances`` with the accumulator limbs of the
    freshly-proven inner EigenTrust snark (the caller persists the
    public inputs *after* this returns, exactly like handle_th_proof
    writes them post-proof, cli.rs:542-583). Both proves, the inner
    EigenTrust snark's and the Threshold circuit's, run rounds 3–4 on
    ``device`` (None: the card, and raises without one before any work;
    a CPU device proves on the host)."""
    from ..device import resolve_device
    if setup.et_setup is None or setup.ratio is None:
        raise EigenError(
            "proving_error",
            "ThSetup lacks the EigenTrust context; build it via "
            "Client.th_circuit_setup",
        )
    device = resolve_device(device)
    p = _load_params(params)
    with trace.span("th.et_setup_circuit"):
        et_chips, et_pubs = _et_setup_circuit(setup.et_setup, shape)
    chips, pubs = _aggregate_th_circuit(
        p, et_chips, et_pubs, setup.pub_inputs.address,
        setup.pub_inputs.threshold, setup.ratio, shape,
        cache_key=(_params_digest(params), shape), device=device,
    )
    expected_head = [
        int(setup.pub_inputs.address),
        int(setup.pub_inputs.threshold),
        1 if setup.pub_inputs.threshold_check else 0,
    ]
    if pubs[:3] != expected_head:
        raise EigenError(
            "proving_error",
            "threshold circuit public inputs diverge from the setup",
        )
    setup.pub_inputs.agg_instances = [Fr(v) for v in pubs[3:]]
    with trace.span("th.outer_prove"):
        return _prove(p, _load_pk(pk), chips.cs, device=device)


def _accumulator_from_limbs(limbs: list):
    """16 Fr limb instances → (lhs, rhs) G1 pair (inverse of
    ``aggregator.accumulator_limbs``)."""
    from .bn254 import g1_is_on_curve
    from .integer_chip import NUM_LIMBS, from_limbs

    if len(limbs) != 4 * NUM_LIMBS:
        raise EigenError("verification_error",
                         f"expected {4 * NUM_LIMBS} accumulator limbs, "
                         f"got {len(limbs)}")
    coords = [from_limbs(limbs[i * NUM_LIMBS:(i + 1) * NUM_LIMBS])
              for i in range(4)]
    lhs = (coords[0], coords[1])
    rhs = (coords[2], coords[3])
    for pt in (lhs, rhs):
        if not g1_is_on_curve(pt):
            raise EigenError("verification_error",
                             "accumulator limbs do not encode G1 points")
    return lhs, rhs


def verify_th(params: bytes, pk: bytes, pub_inputs: bytes, proof: bytes,
              shape: CircuitShape = DEFAULT_SHAPE) -> bool:
    """PLONK-verify the Threshold proof, then run the deferred KZG
    decider over the accumulator limbs it exposes (the one pairing that
    attests to the aggregated EigenTrust snark, lib.rs:665-673 +
    aggregator decide)."""
    from ..client.circuit_io import ThPublicInputs
    from .kzg import decide
    from .plonk import verify

    p = _load_params_verifier(params)
    pubs = ThPublicInputs.from_bytes(pub_inputs)
    flat = [int(x) for x in pubs.to_flat()]
    if not verify(p, _load_vk(pk), flat, proof):
        return False
    lhs, rhs = _accumulator_from_limbs(pubs.agg_instances)
    return decide(p, lhs, rhs)
