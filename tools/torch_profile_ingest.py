#!/usr/bin/env python3
"""Where one ingest chunk of the torch port spends its time on the card.

    python tools/torch_profile_ingest.py [--lanes 32768] [--distinct 256]

Signs ``--distinct`` attestations on the host (16 signers), tiles them
to ``--lanes``, and runs one chunk of each device stage of
``recover_signers_batch`` — the batched Poseidon hash
(``PoseidonBatch.hash_batch``) and the pubkey recovery
(``secp_batch.recover_batch``) — once to warm up and once under
``torch.profiler``. Prints one JSON line per stage: host wall time,
device busy time (the union of kernel intervals), the device's idle
share of the window, launches of each field kernel, the host seconds of
the recovery's limb prep and GLV split, device time and events per
kernel name, and the copy events (``copy_events``). Needs a CUDA
device; imports nothing of JAX or ``protocol_tpu``.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def profile_stage(stage) -> dict:
    """One warm-up call of ``stage``, then one under the profiler, with
    the field kernels' launches and the recovery's host seconds of the
    profiled call."""
    from torch_profile_sweep import profile

    from protocol_tpu_torch.ops import secp_batch as sb
    from protocol_tpu_torch.ops.kernels import field_kernel as fk

    def reset():
        fk.reset_launches()
        sb.reset_host_seconds()

    rec = profile(stage, reset=reset)
    return {**rec, "field_launches": dict(fk.LAUNCHES),
            "host_s": dict(sb.HOST_SECONDS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=32_768)
    ap.add_argument("--distinct", type=int, default=256)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_ingest: no CUDA device", file=sys.stderr)
        return 2
    from protocol_tpu_torch.client.attestation import (
        AttestationData,
        SignatureData,
        SignedAttestationData,
    )
    from protocol_tpu_torch.client.ingest import _att_rows
    from protocol_tpu_torch.crypto.secp256k1 import N, EcdsaKeypair
    from protocol_tpu_torch.ops import secp_batch as sb
    from protocol_tpu_torch.ops.poseidon_batch import get_poseidon_batch

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    rng = random.Random(0)
    kps = [EcdsaKeypair(rng.randrange(1, N)) for _ in range(16)]
    base = []
    for i in range(args.distinct):
        data = AttestationData(rng.randbytes(20), rng.randbytes(20),
                               rng.randrange(256), rng.randbytes(32))
        sig = kps[i % 16].sign(int(data.to_scalar().hash()))
        base.append(SignedAttestationData(data,
                                          SignatureData.from_signature(sig)))
    atts = [base[i % args.distinct] for i in range(args.lanes)]
    rows = _att_rows(atts)
    sigs = [a.signature.to_signature() for a in atts]
    pb = get_poseidon_batch(device="cuda")
    msgs = pb.hash_batch(rows)

    rec = profile_stage(lambda: pb.hash_batch(rows))
    print(json.dumps({"stage": "hash", "lanes": args.lanes, "card": card,
                      **rec}), flush=True)
    rec = profile_stage(lambda: sb.recover_batch(
        [s.r for s in sigs], [s.s for s in sigs], [s.rec_id for s in sigs],
        msgs, device="cuda"))
    print(json.dumps({"stage": "recover", "lanes": args.lanes, "card": card,
                      **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
