"""protocol_tpu_torch — the PyTorch and CUDA port of ``protocol_tpu``.

It runs the EigenTrust converge (the gather path and the Clos-routed
path) on an NVIDIA H100, with the TPU's Pallas kernels rewritten by hand
for Hopper (``ops/kernels``). Module names mirror the reference package
so each counterpart is easy to find; nothing here imports ``jax`` or
``protocol_tpu``.

- ``graph``    — edge filtering and the gather operator (numpy copy)
- ``native``   — the C++ Clos planner, built with g++ at first use
- ``ops``      — converge core, Clos planner/executor, routed operator,
                 and the hand-written kernels
- ``backend``  — the ConvergeBackend seam on torch (and the topic batch)
- ``incremental`` — the delta engine and the refresh ladder (churn
                 without a routing-plan rebuild)
- ``utils.trace`` — spans and typed instruments, the reference's names
- ``client``   — the client SDK (codecs, storage, chains, the ``Client``
                 facade) and the batched ingest on the card
- ``scenarios`` — the adversarial harness: seeded attack topologies,
                 robustness metrics, ``run_scenario``
- ``parallel`` — the device mesh: row-sharded and Clos-routed converges,
                 the checkpointed loop, lane-sharded ingest, the
                 sharded NTT and round 3 of the prover
- ``entry``    — the flagship step (20 routed sweeps on a 4096-peer graph)
                 and the multi-device dry run
- ``cli``      — ``python -m protocol_tpu_torch.cli``: ``attest``,
                 ``attestations``, ``deploy``, ``show``, ``update``,
                 ``bandada``, ``local-scores``, ``scores``, ``scenario``,
                 ``sparse-scores`` and ``profile``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise.
"""

__version__ = "0.1.0"
