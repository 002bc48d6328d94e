"""ZK layer of the port: constraint system, gadgets, the EigenTrust and
Threshold circuits and the KZG/PLONK proving stack, with rounds 3–4 of the prover
on the card (reference: the ``eigentrust-zk`` crate's circuit side; the
counterpart of ``protocol_tpu/zk``).

Modules
-------
- ``api``: stable byte-artifact facade for the CLI/Client (params,
  proving keys, ET/Threshold proofs, verification, the EVM verifier).
- ``plonk`` / ``prover_fast``: the proving system (pure Python twin +
  native-kernel prover producing identical transcripts).
- ``prover_tpu``: the device round-3/4 engine of ``prove_fast_tpu`` on
  torch (``ops/ntt_tpu.py``, ``ops/fieldops2.py`` and the B2 field
  kernels).
- ``commit_engine`` / ``shards``: batched host commitments and the
  intra-prove work units.
- ``kzg`` / ``bn254`` / ``domain``: commitment scheme and field/curve
  backends.
- ``gadgets`` / ``poseidon_chip`` / ``integer_chip`` / ``ecc_chip`` /
  ``ecdsa_chip``: the chip layer.
- ``eigentrust_circuit`` / ``threshold_circuit``: the two product
  circuits.
- ``transcript`` / ``aggregator`` / ``loader_chip``: Fiat–Shamir and
  recursive aggregation (native + in-circuit).
- ``evm`` / ``yul``: generated Yul on-chain verifier + the in-repo
  executor for it.
- ``fabric``: the cross-process proving fabric (work units published
  under a daemon's state dir, executed by ``prove-worker`` processes).

Not ported yet (ROADMAP A6b): the device MSM and the EdDSA, Rescue and
Merkle chips.
"""
