"""The port's device prover against the JAX package's prover: the limb
engine, the NTT and whole proofs.

The port runs here on the CPU, where B2 and its companions take their
plain torch versions and the NTT's stage product its float64 plain
version; the kernels themselves are held to those on the card
(``chip_smoke.py`` phase prove). Oracles from the JAX package are its
host prover and core (``protocol_tpu.zk.prover_fast.prove_fast``,
``protocol_tpu.native.FieldKernel``) plus one small case each of its
``ops/ntt_tpu.py`` and ``ops/fieldops2.py``: its ``DeviceProver`` is
never built (its CPU compile takes minutes). The two engines keep
different Montgomery radixes (the reference 2^276, the port B2's
2^264), so limbs are compared as VALUES mod p, never as arrays.
"""

import random

import numpy as np
import pytest
import torch

from protocol_tpu import native as ref_native
from protocol_tpu.zk import prover_fast as ref_pf
from protocol_tpu.zk.domain import EvaluationDomain
from protocol_tpu_torch.native import prover as port_native
from protocol_tpu_torch.ops import fieldops2 as f2
from protocol_tpu_torch.ops import ntt_tpu
from protocol_tpu_torch.utils.fields import BN254_FR_MODULUS as P
from protocol_tpu_torch.zk import prover_fast as pf
from protocol_tpu_torch.zk import prover_tpu as ptpu
from protocol_tpu_torch.zk.plonk import ConstraintSystem, verify

if not (port_native.available() and ref_native.available()):
    pytest.skip("a prover core did not build", allow_module_level=True)

CPU = torch.device("cpu")


def rand_fr(n: int, seed: int):
    """(n, 4) u64 rows and the ints of n seeded Fr values."""
    rng = random.Random(seed)
    vals = [rng.randrange(P) for _ in range(n)]
    vals[:3] = [0, 1, P - 1][:n]
    return ref_native.ints_to_limbs(vals), vals


def fs_to_natural(rows, plan):
    return rows.reshape(plan.A, plan.B, 4).transpose(1, 0, 2).reshape(-1, 4)


# --- the NTT ------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 4, 5, 6])
def test_ntt_forms_equal_the_reference_core(k):
    """Forward, inverse and coset NTT as canonical values, equal to the
    reference's ``FieldKernel`` (the port's core is its copy)."""
    n = 1 << k
    fk = ref_native.FieldKernel(P)
    omega = EvaluationDomain(k).omega
    plan = ntt_tpu.NttPlan.get(k, CPU)
    arr, _ = rand_fr(n, 50 + k)
    x = f2.upload_mont(arr, CPU)
    host = arr.copy()
    fk.ntt(host, omega)
    assert np.array_equal(fs_to_natural(f2.download_std(
        ntt_tpu.ntt(x, plan)), plan), host)
    host = fs_to_natural(arr, plan).copy()
    fk.ntt(host, omega, inverse=True)
    assert np.array_equal(f2.download_std(ntt_tpu.intt(x, plan)), host)
    shift = 7
    host = arr.copy()
    fk.coset_scale(host, shift)
    fk.ntt(host, omega)
    coset = ntt_tpu.ntt(f2.mont_mul(x, f2.powers_vector(shift, n, CPU)),
                        plan)
    assert np.array_equal(fs_to_natural(f2.download_std(coset), plan), host)


def test_ntt_equals_the_reference_four_step():
    """The reference's own four-step NTT (its int8-plane matmuls on jax,
    k = 4): the same values in the same FS layout."""
    from protocol_tpu.ops import fieldops2 as rf2
    from protocol_tpu.ops import ntt_tpu as rntt

    k = 4
    arr, vals = rand_fr(1 << k, 9)
    r_inv = pow(rf2.R_MONT, -1, P)
    ref_plan = rntt.NttPlan.get(k)
    ref_in = rf2.ints_to_planes([v * rf2.R_MONT % P for v in vals])
    ref_out = [v * r_inv % P for v in
               rf2.planes_to_ints(np.asarray(rntt.ntt(ref_in, ref_plan)))]
    plan = ntt_tpu.NttPlan.get(k, CPU)
    got = ref_native.limbs_to_ints(f2.download_std(
        ntt_tpu.ntt(f2.upload_mont(arr, CPU), plan)))
    assert (plan.A, plan.B) == (ref_plan.A, ref_plan.B)
    assert got == ref_out


# --- the limb engine ----------------------------------------------------------

def test_limb_engine_equals_reference_by_value():
    """256 lanes: products, sums and differences against the reference
    engine's (values mod p, each engine in its own Montgomery domain),
    and the batched inverse, row sum and powers against Python ints."""
    from protocol_tpu.ops import fieldops2 as rf2

    n = 256
    xa, xs = rand_fr(n, 1)
    ya, ys = rand_fr(n, 2)
    x, y = f2.upload_mont(xa, CPU), f2.upload_mont(ya, CPU)
    rr = rf2.R_MONT
    rx = rf2.ints_to_planes([v * rr % P for v in xs])
    ry = rf2.ints_to_planes([v * rr % P for v in ys])

    def ref_vals(planes):
        r_inv = pow(rr, -1, P)
        return [v * r_inv % P for v in rf2.planes_to_ints(np.asarray(planes))]

    def port_vals(t):
        return ref_native.limbs_to_ints(f2.download_std(t))

    assert port_vals(f2.mont_mul(x, y)) == ref_vals(rf2.mont_mul(rx, ry)) \
        == [a * b % P for a, b in zip(xs, ys)]
    assert port_vals(f2.add(x, y)) == ref_vals(rf2.add(rx, ry))
    assert port_vals(f2.sub(x, y)) == ref_vals(rf2.sub(rx, ry))
    nz = [v or 5 for v in xs]
    inv = f2.batch_inv(f2.upload_mont(ref_native.ints_to_limbs(nz), CPU))
    assert port_vals(inv) == [pow(v, -1, P) for v in nz]
    assert port_vals(f2.sum_rows(x)) == [sum(xs) % P]
    assert port_vals(f2.powers_vector(xs[7], 37, CPU)) == \
        [pow(xs[7], i, P) for i in range(37)]
    # the stage-product plane split and fold: Σ planes·2^6i = the value
    planes = f2.to_planes(x).long()
    assert [sum(int(planes[j, i]) << (6 * i) for i in range(f2.L6))
            for j in range(3)] == [v * f2.R_MONT % P for v in xs[:3]]


# --- whole proofs -------------------------------------------------------------

def lockstep_cs(rows: int = 20, seed: int = 11) -> ConstraintSystem:
    rng = random.Random(seed)
    cs = ConstraintSystem(lookup_bits=6)
    for _ in range(rows):
        a, b = rng.randrange(50), rng.randrange(50)
        cs.add_row([a, b, (a * b + a) % P], q_a=1, q_mul_ab=1, q_c=P - 1)
    lk = cs.lookup_row(37)
    row = cs.add_row([37], q_a=1, q_const=P - 37)
    cs.copy(lk, (0, row))
    cs.public_input(777)
    cs.check_satisfied()
    return cs


@pytest.fixture(scope="module")
def artifacts():
    params = pf.setup_params_fast(6, seed=b"lockstep")
    cs = lockstep_cs()
    pk = pf.keygen_fast(params, cs, eval_pk=True)
    ref_params = ref_pf.KZGParams.from_bytes(params.to_bytes())
    ref_pk = ref_pf.FastProvingKey.from_bytes(pk.to_bytes())
    return params, pk, cs, ref_params, ref_pk


@pytest.fixture(scope="module")
def proofs(artifacts):
    """The port's ``prove_fast_tpu`` at k = 6 on the CPU in resident and
    in streaming residency, and the reference's host ``prove_fast``,
    all from one seeded blinding stream."""
    params, pk, cs, ref_params, ref_pk = artifacts
    r = random.Random(42)
    want = ref_pf.prove_fast(ref_params, ref_pk, lockstep_cs(),
                             randint=lambda: r.randrange(P))
    out = {}
    for mode in ("resident", "streaming"):
        pf._DEVICE_PROVERS.clear()
        dp = ptpu.DeviceProver(
            pk.k, pf._find_coset_shifts(4 << pk.k, 2)[1],
            [pk.fixed_limbs[i] for i in range(len(pf.FIXED_NAMES))],
            [pk.sigma_limbs[w] for w in range(pf.NUM_WIRES)],
            ext_resident=(mode == "resident"), device=CPU)
        pf._DEVICE_PROVERS.insert(0, (pk, dp))
        r = random.Random(42)
        out[mode] = pf.prove_fast_tpu(params, pk, cs, device=CPU,
                                      randint=lambda: r.randrange(P))
        assert pf._DEVICE_PROVERS[0][1] is dp
    pf._DEVICE_PROVERS.clear()
    return want, out


@pytest.mark.parametrize("mode", ["resident", "streaming"])
def test_prove_fast_tpu_bytes_equal_reference_host(artifacts, proofs, mode):
    params, pk, cs, ref_params, ref_pk = artifacts
    want, got = proofs
    assert got[mode] == want
    assert verify(params, pk, cs.public_values(), got[mode])


@pytest.mark.parametrize("what", ["byte", "public_input"])
def test_tampered_proof_rejected(artifacts, proofs, what):
    params, pk, cs, _, _ = artifacts
    proof = proofs[1]["resident"]
    pubs = cs.public_values()
    if what == "byte":
        bad = bytearray(proof)
        bad[len(bad) // 3] ^= 1
        assert not verify(params, pk, pubs, bytes(bad))
    else:
        assert not verify(params, pk, [(pubs[0] + 1) % P], proof)


def test_prove_auto_raises_when_the_device_prove_fails(artifacts,
                                                       monkeypatch):
    """With a card reported present, a device prover that fails makes
    ``prove_auto`` raise: no host proof comes back (the reference falls
    back to the host here; the port does not, ROADMAP C)."""
    params, pk, cs, _, _ = artifacts

    def fault(*a, **kw):
        raise RuntimeError("device fault")

    def host(*a, **kw):
        raise AssertionError("prove_auto fell back to the host prover")

    monkeypatch.setattr(pf, "_cuda_present", lambda: True)
    monkeypatch.setattr(ptpu.DeviceProver, "__init__", fault)
    monkeypatch.setattr(pf, "prove_fast", host)
    pf._DEVICE_PROVERS.clear()
    with pytest.raises(RuntimeError, match="device fault"):
        pf.prove_auto(params, pk, cs)
    with pytest.raises(RuntimeError, match="device fault"):
        pf.prove_auto(params, pk, cs, device="cuda")
    assert pf._DEVICE_PROVERS == []


def test_prove_auto_routes_by_device(artifacts, monkeypatch):
    """A CPU device, or no card, proves on the host; an eval-form key on
    a CUDA device goes to ``prove_fast_tpu`` with that device."""
    params, pk, cs, _, _ = artifacts
    calls = []
    monkeypatch.setattr(pf, "prove_fast",
                        lambda *a, **kw: calls.append("host") or b"h")
    monkeypatch.setattr(pf, "prove_fast_tpu", lambda *a, **kw: calls.append(
        ("device", str(kw["device"]))) or b"d")
    monkeypatch.setattr(pf, "_cuda_present", lambda: False)
    assert pf.prove_auto(params, pk, cs) == b"h"
    assert pf.prove_auto(params, pk, cs, device="cpu") == b"h"
    assert pf.prove_auto(params, pk, cs, device="cuda:1") == b"d"
    monkeypatch.setattr(pf, "_cuda_present", lambda: True)
    assert pf.prove_auto(params, pk, cs) == b"d"
    assert calls == ["host", "host", ("device", "cuda:1"),
                     ("device", "cuda")]


def test_profile_prove_workload_covers_the_prove(tmp_path, capsys):
    """``profile --workload prove --device cpu`` (the host path there)
    passes its stage coverage check and reports the stages."""
    import json

    from protocol_tpu_torch.cli.main import main as port_main
    from protocol_tpu_torch.utils import trace

    out = tmp_path / "r.json"
    was = trace.TRACER.enabled
    try:
        assert port_main(["profile", "--workload", "prove", "--k", "7",
                          "--gates", "40", "--device", "cpu", "--json",
                          str(out), "--min-coverage", "0.9"]) == 0
    finally:
        trace.TRACER.reset()
        trace.TRACER.reset_instruments()
        trace.sync_spans(False)
        if not was:
            trace.disable()
    rep = json.loads(out.read_text())
    assert rep["meta"]["workload"] == "prove" and rep["coverage"] >= 0.9
    assert {"commit.r1", "quotient", "openings"} <= set(rep["stages"])
    assert "STAGE_COVERAGE" in capsys.readouterr().out


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_msm_over_row_ranges_equals_one_range(monkeypatch, parts):
    """An MSM split over row ranges (one thread each, partial points
    added on the host) gives the point of the unsplit kernel call, and
    the reference core's, for one column and for several with flips."""
    from protocol_tpu_torch.zk.bn254 import BN254_FQ_MODULUS as Q
    from protocol_tpu_torch.zk.bn254 import G1_GEN, g1_mul

    n = 600
    rng = random.Random(parts)
    points = [g1_mul(G1_GEN, rng.randrange(1, P)) for _ in range(40)]
    bases = port_native.ints_to_limbs(
        [c for i in range(n) for c in points[i % 40]]).reshape(n, 8)
    bases[7] = 0  # an identity base
    cols = np.stack([rand_fr(n, 10 * parts + k)[0] for k in range(3)])
    cols[2, : n // 2] = 0  # a column whose first ranges sum to nothing
    flips = np.array([[rng.randrange(2) for _ in range(n)]
                      for _ in range(3)], dtype=np.uint8)
    whole = port_native.g1_msm_multi(Q, bases, cols, flips)
    single = port_native.g1_msm(Q, bases, cols[0])
    assert whole == ref_native.g1_msm_multi(Q, bases, cols, flips)
    monkeypatch.setattr(port_native, "MSM_SPLIT_MIN_ROWS", n // parts)
    monkeypatch.setattr(port_native, "msm_threads", lambda: parts)
    assert len(port_native._row_ranges(n)) == parts
    assert port_native.g1_msm_multi(Q, bases, cols, flips) == whole
    assert port_native.g1_msm(Q, bases, cols[0]) == single
    assert port_native.g1_msm(Q, bases[:n // parts], cols[0][:n // parts]) \
        == ref_native.g1_msm(Q, bases[:n // parts], cols[0][:n // parts])
