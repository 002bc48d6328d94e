"""The flagship step on torch (twin of ``__graft_entry__.entry()``) and
the multi-device dry run (twin of ``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .graph import barabasi_albert_edges
from .ops.routed import build_routed_operator, converge_routed_fixed, routed_arrays


def entry(device=None):
    """``(forward, (arrs, s0))``: 20 Clos-routed damped power-iteration
    sweeps (α = 0.1) on the 4096-peer Barabási–Albert graph (m = 6,
    seed 42), float32. ``forward(arrs, s0)`` returns the state-order
    scores after the 20 sweeps."""
    device = resolve_device(device)
    n = 4096
    src, dst, val = barabasi_albert_edges(n, 6, seed=42)
    op = build_routed_operator(n, src, dst, val)
    arrs, static = routed_arrays(op, dtype=torch.float32, alpha=0.1,
                                 device=device)
    s0 = torch.from_numpy(op.initial_scores(1000.0)).to(device)

    def forward(arrs, s0):
        return converge_routed_fixed(arrs, static, s0, 20)

    return forward, (arrs, s0)


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _conserved(scores: np.ndarray, n_valid: int) -> None:
    total = float(np.sum(scores, dtype=np.float64))
    expected = n_valid * 1000.0
    _expect(abs(total - expected) / expected < 1e-3,
            f"mass not conserved: {total} vs {expected}")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the sharded step over an ``n_devices`` mesh on small shapes
    and check it: the row-sharded gather converge (2 fixed sweeps and a
    short adaptive run, with conservation), the sharded Clos-routed
    converge when ``n_devices`` divides 128, one sharded round-3
    quotient chunk bit-identical to the ``DeviceProver``'s, and the
    lane-sharded ingest bit-identical to the single-device path.

    ``devices`` defaults to the first ``n_devices`` GPUs (raises when
    there are fewer); a caller may pass a list that repeats one device
    (a virtual mesh, each shard running its own kernels). On a CPU mesh
    the ingest check compares the sharded prep stage only, as the
    reference's dry run does on XLA:CPU: each shard's recovery ladder
    costs seconds there."""
    from .parallel import (
        build_sharded_operator,
        build_sharded_routed_operator,
        make_mesh,
        sharded_converge_adaptive,
        sharded_converge_fixed,
        sharded_routed_converge_adaptive,
    )

    mesh = make_mesh(n_devices, devices=devices)

    # n = 8192 with real hub structure and a SHORT ADAPTIVE RUN
    n = 8192
    src, dst, val = barabasi_albert_edges(n, 4, seed=7)
    sop = build_sharded_operator(n, src, dst, val, num_shards=n_devices)
    s0 = sop.initial_scores(1000.0, dtype=torch.float32)

    # fixed steps (reference-parity mode)
    out = sharded_converge_fixed(sop, s0, 2, mesh).cpu().numpy()
    _expect(np.isfinite(out).all(), "non-finite fixed-step scores")

    # short adaptive run (tolerance mode with damping)
    scores, _, _ = sharded_converge_adaptive(
        sop, s0, mesh, tol=0.0, max_iterations=3, alpha=0.1)
    scores = scores.cpu().numpy()[: sop.n]
    _expect(np.isfinite(scores).all(), "non-finite adaptive scores")
    _conserved(scores, sop.n_valid)

    # sharded Clos-routed path: lane-perm stages + all_to_all shuffles.
    # Subnetwork ownership needs the device count to divide 128; other
    # counts are served by the gather path above.
    if 128 % n_devices == 0:
        rop = build_sharded_routed_operator(n, src, dst, val,
                                            num_shards=n_devices)
        r_scores, _, _ = sharded_routed_converge_adaptive(
            rop, rop.initial_scores(1000.0), mesh, tol=0.0,
            max_iterations=3, alpha=0.1)
        r_np = rop.scores_for_nodes(r_scores)
        _expect(np.isfinite(r_np).all(), "non-finite routed scores")
        _conserved(r_np, rop.n_valid)

    _dryrun_sharded_prover(n_devices, mesh)
    _dryrun_sharded_ingest(n_devices, mesh)


def _dryrun_sharded_ingest(n_devices: int, mesh) -> None:
    """Lane-sharded attestation ingest on the mesh over real signatures,
    bit-identical to the single-device path, one degenerate lane
    rejected on both (on a CPU mesh: the prep stage both ways)."""
    import random

    from .crypto.secp256k1 import EcdsaKeypair
    from .ops.secp_batch import SECP_N, recover_batch
    from .parallel.ingest import sharded_prep_parity, sharded_recover_batch

    rng = random.Random(0xA1)
    k = max(16, 2 * n_devices)
    k += -k % n_devices  # lane count must divide the mesh
    kps = [EcdsaKeypair(77_000 + i) for i in range(k)]
    msgs = [rng.randrange(1, SECP_N) for _ in range(k)]
    sigs = [kp.sign(m) for kp, m in zip(kps, msgs)]
    rs = [s.r for s in sigs]
    ss = [s.s for s in sigs]
    recs = [s.rec_id for s in sigs]
    # one degenerate lane: the binding checks must flag it on both paths
    ss[1] = 0

    if mesh.devices[0].type == "cpu":
        single, sharded, range_ok = sharded_prep_parity(
            rs, ss, recs, msgs, mesh)
        for name, a, b in zip(("r_m", "y_sel", "lift_ok", "u1", "u2"),
                              single, sharded):
            _expect(np.array_equal(a, b),
                    f"sharded ingest prep diverged at {name}")
        _expect(not range_ok[1] and range_ok.sum() == k - 1,
                "the degenerate lane passed the range check")
        return

    xs0, ys0, v0 = recover_batch(rs, ss, recs, msgs, device=mesh.devices[0])
    xs1, ys1, v1 = sharded_recover_batch(rs, ss, recs, msgs, mesh)
    _expect((v0 == v1).all(), "sharded ingest validity diverged")
    _expect(not v0[1] and v0.sum() == k - 1,
            "the degenerate lane was accepted")
    _expect(xs0 == xs1 and ys0 == ys1, "sharded ingest keys diverged")
    for i, kp in enumerate(kps):
        if i != 1:
            _expect((xs1[i], ys1[i]) == (kp.public_key.point.x,
                                         kp.public_key.point.y),
                    f"lane {i} recovered another key")


def _dryrun_sharded_prover(n_devices: int, mesh) -> None:
    """Sharded PLONK round 3 on the mesh: ext chunks, one z-split
    quotient chunk and its column blocks, bit-identical to the
    single-device ``DeviceProver``'s."""
    from .parallel.prover import ShardedRound3
    from .utils.fields import BN254_FR_MODULUS as P
    from .zk import prover_tpu as ptpu
    from .zk.plonk import _find_coset_shifts

    k = 8
    n = 1 << k
    shift = _find_coset_shifts(n * 4, 2)[1]
    rng = np.random.default_rng(17)
    dev = mesh.devices[0]

    def ru(seed):
        out = np.zeros((n, 4), dtype="<u8")
        r = np.random.default_rng(seed)
        for i in range(n):
            v = int.from_bytes(r.bytes(32), "little") % P
            out[i] = np.frombuffer(v.to_bytes(32, "little"), dtype="<u8")
        return out

    dp = ptpu.DeviceProver(k, shift, [ru(10 + i) for i in range(9)],
                           [ru(30 + i) for i in range(6)], device=dev)
    if dp.B % n_devices:
        return  # shard count must divide the NTT grid's B axis
    sp = ShardedRound3(dp, mesh)
    wires_c = [ptpu.upload_mont(ru(50 + w), dev) for w in range(6)]
    others = [ptpu.upload_mont(ru(60 + i), dev) for i in range(8)]
    z_c, m_c, phi_c, pi_c = others[:4]
    uv_c = others[4:]
    beta, gamma, beta_lk, alpha = [int(x) for x in
                                   rng.integers(1, 2**62, 4)]
    shifts = _find_coset_shifts(n, 6)
    ch = dp.challenge_planes(beta, gamma, beta_lk, alpha, shifts)
    j = 0
    expect = dp.quotient_chunk(
        j, [dp.ext_chunk(c, j) for c in wires_c], dp.ext_chunk(z_c, j),
        dp.ext_chunk(m_c, j), dp.ext_chunk(phi_c, j),
        dp.ext_chunk(pi_c, j), [dp.ext_chunk(c, j) for c in uv_c], ch)

    def ext(c):
        return sp.ext_chunk(sp.shard(c), j)

    got = sp.gather(sp.quotient_chunk(
        j, [ext(c) for c in wires_c], ext(z_c), ext(m_c), ext(phi_c),
        ext(pi_c), [ext(c) for c in uv_c], ch))
    _expect(torch.equal(got, expect), "sharded quotient diverged")
