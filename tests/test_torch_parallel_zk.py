"""The port's lane-sharded ingest (``parallel/ingest.py``), sharded NTT
(``parallel/ntt.py``) and sharded round 3 (``parallel/prover.py``) held
bit for bit against the port's single-device functions, which the
earlier slices' tests hold against the reference. The reference's
sharded ladder, NTT and round 3 are not run here: their XLA:CPU
compiles take minutes.

Meshes repeat ``torch.device("cpu")`` (D ∈ {2, 4, 8}), every shard
running the field kernels' plain versions; inputs come from numpy and
``random`` seeds. Twins of ``tests/test_ingest.py`` (the sharded
recovery), ``tests/test_parallel_ntt.py`` and
``tests/test_parallel_prover.py``.
"""

import random

import numpy as np
import pytest
import torch

from protocol_tpu_torch.crypto.secp256k1 import (
    EcdsaKeypair,
    recover_public_key,
)
from protocol_tpu_torch.ops import fieldops2 as f2
from protocol_tpu_torch.ops import ntt_tpu
from protocol_tpu_torch.ops import secp_batch as sb
from protocol_tpu_torch.parallel.ingest import sharded_recover_batch
from protocol_tpu_torch.parallel.mesh import make_mesh
from protocol_tpu_torch.parallel.ntt import ntt_sharded
from protocol_tpu_torch.parallel.prover import ShardedRound3
from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
from protocol_tpu_torch.zk import prover_tpu as ptpu
from protocol_tpu_torch.zk.plonk import _find_coset_shifts

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread for these tests: they run thousands of tiny
    torch ops and small float64 matmuls, which a pool of one thread a
    core slows some fifty times over when the suite's other workers hold
    the cores (the pool's threads wait on each other); alone they run
    as fast either way."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(d):
    return make_mesh(devices=[CPU] * d)


# --- lane-sharded ingest (tests/test_ingest.py) ------------------------------

def _signed_lanes(k, seed):
    rng = random.Random(seed)
    kps = [EcdsaKeypair(91_000 + i) for i in range(k)]
    msgs = [rng.randrange(1, sb.SECP_N) for _ in range(k)]
    sigs = [kp.sign(m) for kp, m in zip(kps, msgs)]
    return (kps, sigs, [s.r for s in sigs], [s.s for s in sigs],
            [s.rec_id for s in sigs], msgs)


def test_lane_sharded_recovery_bit_identical():
    """Both device stages sharded over two shards: every valid lane's key
    equal to the host's ``recover_public_key`` (the oracle
    ``tests/test_torch_ingest.py`` holds the single-device
    ``recover_batch`` to, lane for lane), forged lanes included, and the
    mask the single-device path's acceptance set. A CPU recovery ladder
    costs seconds (one a shard), so the single-device ladder itself is
    held beside the sharded one on the card (``chip_smoke.py``, all
    65,536 lanes, invalid ones too)."""
    kps, sigs, rs, ss, recs, msgs = _signed_lanes(8, 0x5EED)
    ss[3] = 0                      # binding-check reject
    msgs[5] = (msgs[5] + 1) % sb.SECP_N  # a forged message: another key
    xs, ys, valid = sharded_recover_batch(rs, ss, recs, msgs, cpu_mesh(2))
    assert valid.tolist() == [i != 3 for i in range(8)]
    for i in range(8):
        if i != 3:
            pk = recover_public_key(sigs[i], msgs[i]).point
            assert (xs[i], ys[i]) == (pk.x, pk.y)
    assert (xs[5], ys[5]) != (kps[5].public_key.point.x,
                              kps[5].public_key.point.y)


def test_sharded_recovery_rejects_uneven_lanes():
    with pytest.raises(ValueError, match="divide"):
        sharded_recover_batch([1] * 3, [1] * 3, [0] * 3, [1] * 3,
                              cpu_mesh(2))


class _Stop(Exception):
    pass


def test_the_stage_hooks_reach_the_ingest_pipeline():
    """``hash_recover_pipeline`` and ``recover_stream`` hand their
    ``_prep``/``_glv`` hooks to the recovery stages: the prep hook gets
    the prep stage's five arguments, the ladder hook the ladder's seven,
    and a hook that raises stops the pipeline at its stage."""
    from protocol_tpu_torch.client.ingest import hash_recover_pipeline

    _, _, rs, ss, recs, msgs = _signed_lanes(4, 7)
    rows = [[1, 2, 3, 4]] * 4
    seen = []

    def prep(*args):  # zero rows: the host GLV split between the stages
        seen.append(("prep", len(args)))
        zeros = torch.zeros(len(rs), f2.L, dtype=torch.int32)
        ok = torch.ones(len(rs), dtype=torch.bool)
        return zeros, zeros, ok, zeros, zeros

    def stop(*args):
        seen.append(("stop", len(args)))
        raise _Stop

    with pytest.raises(_Stop):
        list(hash_recover_pipeline([rows], [(rs, ss, recs)], device=CPU,
                                   _prep=prep, _glv=stop))
    with pytest.raises(_Stop):
        list(sb.recover_stream([(rs, ss, recs, msgs)], device=CPU,
                               _prep=stop))
    assert seen == [("prep", 5), ("stop", 7), ("stop", 5)]


# --- the sharded NTT (tests/test_parallel_ntt.py) ----------------------------

def _rand_rows(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    return f2.mont_rows(vals, CPU)


@pytest.mark.parametrize("k,shards", [(10, 8), (10, 2), (8, 4)])
def test_sharded_ntt_bit_exact(k, shards):
    plan = ntt_tpu.NttPlan.get(k, CPU)
    x = _rand_rows(1 << k, 100 + k)
    expect = ntt_tpu.ntt(x, plan)
    got = ntt_sharded(x, plan, cpu_mesh(shards))
    assert torch.equal(got, expect)


def test_sharded_ntt_rejects_bad_shard_count():
    plan = ntt_tpu.NttPlan.get(8, CPU)  # B = 16
    got = ntt_sharded(_rand_rows(1 << 8, 1), plan, cpu_mesh(8))
    assert got.shape == (1 << 8, f2.L)
    plan6 = ntt_tpu.NttPlan.get(6, CPU)  # B = 8
    with pytest.raises(ValueError):
        ntt_sharded(_rand_rows(1 << 6, 2), plan6, cpu_mesh(3))


# --- the sharded round 3 (tests/test_parallel_prover.py) ---------------------

K = 8
N = 1 << K
SHIFT = _find_coset_shifts(N * 4, 2)[1]


def _rand_u64(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    out = np.zeros((n, 4), dtype="<u8")
    for i, v in enumerate(vals):
        out[i] = np.frombuffer(int(v).to_bytes(32, "little"), dtype="<u8")
    return out


def _up(seed):
    return ptpu.upload_mont(_rand_u64(N, seed), CPU)


@pytest.fixture(scope="module")
def dp():
    fixed = [_rand_u64(N, 700 + i) for i in range(9)]
    sigma = [_rand_u64(N, 800 + i) for i in range(6)]
    return ptpu.DeviceProver(K, SHIFT, fixed, sigma, device=CPU)


def _challenges(dp, seed):
    rng = np.random.default_rng(seed)
    beta, gamma, beta_lk, alpha = [int(x) % P for x in
                                   rng.integers(1, 2**62, 4)]
    return dp.challenge_planes(beta, gamma, beta_lk, alpha,
                               _find_coset_shifts(N, 6))


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ext_chunk_bit_exact(dp, shards):
    sp = ShardedRound3(dp, cpu_mesh(shards))
    coeffs = _up(1)
    for j, blinds in ((0, None), (2, [99, 12345])):
        expect = dp.ext_chunk(coeffs, j, blinds=blinds)
        got = sp.gather(sp.ext_chunk(sp.shard(coeffs), j, blinds=blinds))
        assert torch.equal(got, expect)


@pytest.mark.parametrize("shards,j", [(2, 0), (8, 3)])
def test_quotient_chunk_bit_exact(dp, shards, j):
    sp = ShardedRound3(dp, cpu_mesh(shards))
    ch = _challenges(dp, 5)
    wires_e = [dp.ext_chunk(_up(20 + w), j) for w in range(6)]
    z_e, m_e, phi_e, pi_e = (dp.ext_chunk(_up(s), j) for s in (30, 31, 32,
                                                               33))
    uv_e = [dp.ext_chunk(_up(40 + i), j) for i in range(4)]
    expect = dp.quotient_chunk(j, wires_e, z_e, m_e, phi_e, pi_e, uv_e, ch)
    got = sp.gather(sp.quotient_chunk(
        j, [sp.shard(w) for w in wires_e], sp.shard(z_e), sp.shard(m_e),
        sp.shard(phi_e), sp.shard(pi_e), [sp.shard(u) for u in uv_e], ch))
    assert torch.equal(got, expect)


def test_quotient_chunk_needs_a_resident_prover(dp):
    sp = ShardedRound3(dp, cpu_mesh(2))
    dp.ext_resident = False
    try:
        with pytest.raises(ValueError, match="resident"):
            sp.quotient_chunk(0, [], None, None, None, None, [], None)
    finally:
        dp.ext_resident = True


@pytest.mark.parametrize("shards", [4])
def test_intt_ext_bit_exact(dp, shards):
    sp = ShardedRound3(dp, cpu_mesh(shards))
    fs = [ptpu.fs_from_natural(_up(60 + j), dp.A, dp.B).contiguous()
          for j in range(4)]
    expect = dp.intt_ext(list(fs))
    got = sp.intt_ext([sp.shard(c) for c in fs])
    for e, g in zip(expect, got):
        assert torch.equal(sp.gather(g), e)


def test_round3_needs_b_to_divide_over_the_mesh(dp):
    with pytest.raises(ValueError, match="divide"):
        ShardedRound3(dp, cpu_mesh(3))


@pytest.mark.parametrize("shards", [2])
def test_full_round3_pipeline_bit_exact(dp, shards):
    """End to end: ext of every column → quotient on all 4 cosets →
    inverse + combine, the sharded round 3 against the single-device
    engine in one shot."""
    sp = ShardedRound3(dp, cpu_mesh(shards))
    ch = _challenges(dp, 9)
    wires_c = [_up(120 + w) for w in range(6)]
    z_c, m_c, phi_c, pi_c = (_up(s) for s in (130, 131, 132, 133))
    uv_c = [_up(140 + i) for i in range(4)]

    t_single = []
    for j in range(4):
        t_single.append(dp.quotient_chunk(
            j, [dp.ext_chunk(c, j) for c in wires_c],
            dp.ext_chunk(z_c, j), dp.ext_chunk(m_c, j),
            dp.ext_chunk(phi_c, j), dp.ext_chunk(pi_c, j),
            [dp.ext_chunk(c, j) for c in uv_c], ch))
    expect = dp.intt_ext(t_single)

    sh = {k: sp.shard(v) for k, v in
          (("z", z_c), ("m", m_c), ("phi", phi_c), ("pi", pi_c))}
    wires_sh = [sp.shard(c) for c in wires_c]
    uv_sh = [sp.shard(c) for c in uv_c]
    t_shard = []
    for j in range(4):
        t_shard.append(sp.quotient_chunk(
            j, [sp.ext_chunk(c, j) for c in wires_sh],
            sp.ext_chunk(sh["z"], j), sp.ext_chunk(sh["m"], j),
            sp.ext_chunk(sh["phi"], j), sp.ext_chunk(sh["pi"], j),
            [sp.ext_chunk(c, j) for c in uv_sh], ch))
    got = [sp.gather(c) for c in sp.intt_ext(t_shard)]
    for e, g in zip(expect, got):
        assert torch.equal(g, e)
