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
- ``backend``  — the ConvergeBackend seam on torch
- ``entry``    — the flagship step (20 routed sweeps on a 4096-peer graph)
- ``cli``      — ``python -m protocol_tpu_torch.cli sparse-scores``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no device given and no GPU present they raise.
"""

__version__ = "0.1.0"
