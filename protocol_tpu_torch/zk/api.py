"""Stable facade over the proving stack for the CLI / Client layers.

Byte-level artifacts in, byte-level artifacts out — the CLI persists them
via the EigenFile layout exactly like the reference persists halo2's
serialized params/keys/proofs (eigentrust-cli/src/fs.rs:50-84).

The port of ``protocol_tpu/zk/api.py``, its EigenTrust half: twin of the
reference Client's proving surface (eigentrust/src/lib.rs):
``generate_kzg_params`` :588-604, ``generate_et_pk`` :537-558 (dummy
circuit for key shape), ``generate_et_proof`` :239-269 and ``verify``
:304-336. The artifacts are the reference package's, byte for byte: a
key or proof written by either package verifies under the other.

``generate_et_proof`` proves through ``prover_fast.prove_auto``: rounds
3–4 on the card (``device``, default the card; it raises without one
unless given the CPU, where the host prover runs) and rounds 1–2 and
every commitment on the host's C++ prover core. A device prove that
fails raises; it never falls back to the host.

Not ported yet (ROADMAP A6b), each raising an ``EigenError`` that says
so: the Threshold circuit and its recursive aggregation
(``generate_th_pk``, ``generate_th_proof``, ``verify_th``) and the
Yul/EVM verifier (``gen_et_evm_verifier``, ``et_evm_calldata``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

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


_PREWARM_THREADS: list = []


def _prewarm_device_prover(pk_obj) -> None:
    """Best-effort: build (or resume) ``pk_obj``'s DeviceProver on a
    daemon thread, overlapping its device init (pk uploads + iNTTs +
    resident ext-table builds) with the caller's GIL-releasing host
    work. In the reference the Threshold flow's warm path starts this
    before its outer keygen; the port keeps it for that flow (ROADMAP
    A6b). ``_prove`` joins any live prewarm before dispatching — the
    device is never driven concurrently with a prove. A prewarm that
    fails leaves the prove to init on demand, where a failure raises."""
    _join_prewarm()
    import torch

    if not torch.cuda.is_available():
        return
    if not getattr(pk_obj, "eval_form", False) or pk_obj.k > 21:
        return  # prove_auto would not take the device path anyway
    import threading

    def _run():
        try:
            from .prover_fast import _device_prover

            with trace.span("th.inner_dp_prewarm"):
                _device_prover(pk_obj)
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


def _not_ported(what: str):
    raise EigenError(
        "config_error",
        f"{what} is not ported to the torch package yet (ROADMAP A6b)")


def gen_et_evm_verifier(params: bytes, pk: bytes,
                        transcript: str = "keccak") -> str:
    """The Yul/EVM verifier: not ported yet (ROADMAP A6b)."""
    _not_ported("the Yul/EVM verifier")


def et_evm_calldata(pub_inputs: bytes, proof: bytes,
                    shape: CircuitShape = DEFAULT_SHAPE) -> bytes:
    """ABI calldata for the EVM verifier: not ported yet (ROADMAP A6b)."""
    _not_ported("the Yul/EVM verifier")


def generate_th_pk(params: bytes, shape: CircuitShape = DEFAULT_SHAPE) -> bytes:
    """The Threshold proving key: not ported yet (ROADMAP A6b)."""
    _not_ported("the Threshold circuit")


def generate_th_proof(params: bytes, pk: bytes, setup,
                      shape: CircuitShape = DEFAULT_SHAPE) -> bytes:
    """The Threshold proof: not ported yet (ROADMAP A6b)."""
    _not_ported("the Threshold circuit")


def verify_th(params: bytes, pk: bytes, pub_inputs: bytes, proof: bytes,
              shape: CircuitShape = DEFAULT_SHAPE) -> bool:
    """Threshold verification: not ported yet (ROADMAP A6b)."""
    _not_ported("the Threshold circuit")
